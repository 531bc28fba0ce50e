"""Both configurations write their scene and build at a tiny size on the
CPU, through the program's normal path."""

import pytest

from gpu_bench.harness import main
from gpu_bench.tests.tiny import tiny


@pytest.mark.parametrize("workload,config", [("rope.manipulate64", "rope"),
                                             ("pusht.push64", "pusht")])
def test_config_builds(tmp_path, workload, config):
    from real2sim_eval_tpu_torch.config import load_config
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator

    cell = tiny(workload)
    assert cell.config == config
    scene = main.write_scene(cell, 2**31 + 5, tmp_path)
    cfg = load_config(tmp_path / "cfg", "run")
    ev = BatchedEvaluator(cfg, [0, 1], device="cpu")
    s = cell.spec
    n_obj = len(scene["particles"]) + s["object"]["body_splats"]
    assert ev.assets.obj["means3D"].shape[0] == n_obj
    n_scan = s["scan"]["table_splats"] + (s["scan"]["splats_per_link"]
                                          * len(s["scan"]["links"]))
    assert ev.assets.table["means3D"].shape[0] == n_scan
    assert ev.state.sm.x.shape == (2, len(scene["particles"]), 3)
    assert bool(cfg.env.robot.use_pusher) == (config == "pusht")
    # the scene is the seed's: the same seed writes the same particles
    again = main.write_scene(cell, 2**31 + 5, tmp_path / "again")
    assert (again["particles"] == scene["particles"]).all()
