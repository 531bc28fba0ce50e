"""The port's config loader against the JAX package's.

Every ``cfg/*.yaml`` composition of the repo, with the overrides
tests/test_config.py uses (group, dotted, ``+``-created, value parsing),
must give the same tree in both packages; so must the interpolation and
``${eval:...}`` resolver, ``parse_overrides``, ``to_yaml``, and a save and
load round trip."""

import textwrap
from pathlib import Path

import pytest

from real2sim_eval_tpu import config as jcfg
from real2sim_eval_tpu_torch import config as tcfg

CFG_DIR = Path(__file__).resolve().parent.parent / "cfg"
MAIN_CONFIGS = sorted(p.stem for p in CFG_DIR.glob("*.yaml"))
OVERRIDES = [
    [],
    ["gs=sloth", "physics.fps=60"],
    ["gs=T", "env=xarm_pusher", "seed=7"],
    ["+extra.flag=true", "a=null", "b=1e-3", "c=[1,2]", "d=text", "e=false"],
]


def test_all_main_configs_found():
    assert set(MAIN_CONFIGS) == {"eval_policy", "eval_policy_batched",
                                 "keyboard_teleop", "replay"}


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: ",".join(o))
@pytest.mark.parametrize("name", MAIN_CONFIGS)
def test_repo_configs_compose_alike(name, overrides):
    j = jcfg.load_config(CFG_DIR, name, overrides=overrides)
    t = tcfg.load_config(CFG_DIR, name, overrides=overrides)
    assert isinstance(t, tcfg.ConfigNode)
    assert t.to_dict() == j.to_dict()
    assert tcfg.to_yaml(t) == jcfg.to_yaml(j)


@pytest.fixture
def cfg_tree(tmp_path):
    (tmp_path / "env").mkdir()
    (tmp_path / "gs").mkdir()
    (tmp_path / "main.yaml").write_text(textwrap.dedent("""
        defaults:
          - env: robot_a
          - gs: scene_a
          - _self_
          - override hydra/job_logging: disabled
        hydra:
          output_subdir: null
        seed: 0
        dt: 5e-5
        duration: 30
        total: ${eval:'${duration} * 2'}
        label: run_${seed}_${gs.name}
        nested:
          ref: ${seed}
          chain: ${nested.ref}
    """))
    (tmp_path / "env" / "robot_a.yaml").write_text(
        "robot:\n  type: xarm\n  n_grippers: 1\n"
        "cameras:\n  - type: side\n    h: 480\n")
    (tmp_path / "gs" / "scene_a.yaml").write_text("use_shs: false\nname: a\n")
    (tmp_path / "gs" / "scene_b.yaml").write_text("use_shs: true\nname: b\n")
    return tmp_path


@pytest.mark.parametrize("overrides", [[], ["gs=scene_b", "seed=3"],
                                       ["env.robot.type=ur5", "+x.y=1"]])
def test_interpolation_alike(cfg_tree, overrides):
    j = jcfg.load_config(cfg_tree, "main", overrides=overrides)
    t = tcfg.load_config(cfg_tree, "main", overrides=overrides)
    assert t.to_dict() == j.to_dict()
    assert t.total == 60 and t.dt == 5e-5
    assert t.label == f"run_{t.seed}_{t.gs.name}"
    assert t.nested.chain == t.seed
    # unresolved trees agree too
    assert (tcfg.load_config(cfg_tree, "main", overrides, resolve=False)
            .to_dict() == jcfg.load_config(cfg_tree, "main", overrides,
                                           resolve=False).to_dict())


def test_parse_overrides_alike():
    argv = ["--config-name", "x", "gs=sloth", "-v", "+a.b=2", "plain"]
    assert tcfg.parse_overrides(argv) == jcfg.parse_overrides(argv)


def test_save_load_round_trip(tmp_path):
    cfg = tcfg.load_config(CFG_DIR, "eval_policy", overrides=["gs=sloth"])
    tcfg.save_config(cfg, tmp_path / "out" / "cfg.yaml")
    back = tcfg.load_config(tmp_path / "out", "cfg")
    assert back == cfg
    # either package reads the other's file
    assert (jcfg.load_config(tmp_path / "out", "cfg").to_dict()
            == cfg.to_dict())
    jcfg.save_config(jcfg.load_config(CFG_DIR, "replay"),
                     tmp_path / "j" / "cfg.yaml")
    assert (tcfg.load_config(tmp_path / "j", "cfg").to_dict()
            == jcfg.load_config(CFG_DIR, "replay").to_dict())


def test_confignode_surface():
    node = tcfg.ConfigNode({"a": {"b": 1}, "lst": [1, {"x": 2}]})
    assert "a" in node and "b" in node.a
    assert node.select("lst.1.x") == 2
    assert node.get("missing", 5) == 5
    node.update_dotted("a.c.d", 4)
    assert node.a.c.d == 4
    import copy
    import pickle
    assert copy.deepcopy(node) == node
    assert pickle.loads(pickle.dumps(node)) == node
    node.merge({"a": {"b": 10}})
    assert node.a.b == 10 and node.a.c.d == 4
