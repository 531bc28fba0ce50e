"""The port stands alone: it never imports JAX or the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "real2sim_eval_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "real2sim_eval_tpu")


def port_files():
    return sorted(p for p in PORT.rglob("*.py")
                  if "_build" not in p.parts) + [REPO / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax():
    code = ("import sys, real2sim_eval_tpu_torch, "
            "real2sim_eval_tpu_torch.parallel, real2sim_eval_tpu_torch.convert, "
            "real2sim_eval_tpu_torch.testing, real2sim_eval_tpu_torch.ext, "
            "real2sim_eval_tpu_torch.renderer.incremental, "
            "real2sim_eval_tpu_torch.renderer.incremental_fine, "
            "real2sim_eval_tpu_torch.renderer.fine_kernel, "
            "real2sim_eval_tpu_torch.renderer.precull, "
            "real2sim_eval_tpu_torch.renderer.diff, "
            "real2sim_eval_tpu_torch.utils.ply, "
            "real2sim_eval_tpu_torch.experiments.utils.refine_gs, "
            "real2sim_eval_tpu_torch.config, real2sim_eval_tpu_torch.envs, "
            "real2sim_eval_tpu_torch.renderer.renderer, "
            "real2sim_eval_tpu_torch.parallel.assets, "
            "real2sim_eval_tpu_torch.physics.dynamics, "
            "real2sim_eval_tpu_torch.physics.checkpoints, "
            "real2sim_eval_tpu_torch.kinematics.robot, "
            "real2sim_eval_tpu_torch.utils.gs_processor, "
            "real2sim_eval_tpu_torch.utils.logging, "
            "real2sim_eval_tpu_torch.utils.transforms_np, "
            "real2sim_eval_tpu_torch.parallel.mesh, "
            "real2sim_eval_tpu_torch.kinematics, "
            "real2sim_eval_tpu_torch.experiments.cli, "
            "real2sim_eval_tpu_torch.experiments.episode_io, "
            "real2sim_eval_tpu_torch.experiments.policy_api, "
            "real2sim_eval_tpu_torch.experiments.eval_policy, "
            "real2sim_eval_tpu_torch.experiments.eval_policy_batched, "
            "real2sim_eval_tpu_torch.experiments.eval_policy_parallel, "
            "real2sim_eval_tpu_torch.experiments.replay, "
            "real2sim_eval_tpu_torch.experiments.keyboard_teleop, "
            "real2sim_eval_tpu_torch.experiments.utils.dir_utils, "
            "real2sim_eval_tpu_torch.experiments.utils.ffmpeg, "
            "real2sim_eval_tpu_torch.experiments.utils.success, "
            "real2sim_eval_tpu_torch.experiments.utils.calculate_success_rope, "
            "real2sim_eval_tpu_torch.experiments.utils.calculate_success_sloth, "
            "real2sim_eval_tpu_torch.experiments.utils.calculate_success_T, "
            "real2sim_eval_tpu_torch.experiments.utils.create_rigid_phystwin, "
            "real2sim_eval_tpu_torch.experiments.utils.construct_scene, "
            "real2sim_eval_tpu_torch.experiments.utils.color_alignment, "
            "real2sim_eval_tpu_torch.experiments.utils.visualize_scan, "
            "real2sim_eval_tpu_torch.kinematics.xarm_transforms, "
            "real2sim_eval_tpu_torch.utils.icp, "
            "real2sim_eval_tpu_torch.utils.colormap, "
            "real2sim_eval_tpu_torch.utils.viser_gui, "
            "real2sim_eval_tpu_torch.utils.profiling, "
            "real2sim_eval_tpu_torch.utils.splat_viewer, "
            "real2sim_eval_tpu_torch.experiments.utils.trace_step, "
            "real2sim_eval_tpu_torch.experiments.utils.profile_physics, "
            "real2sim_eval_tpu_torch.experiments.utils.visualize_rollouts\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(','.join(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True)
    assert out.stdout.strip() == "", out.stdout


def forbidden_module(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", port_files(), ids=lambda p: p.name)
def test_no_port_file_names_jax_or_the_jax_package(path):
    """No import statement, and no module-name string (an importlib or
    __import__ argument), names JAX or the JAX package. A file path such
    as the "replaces" field of chip_smoke.py's kernel line is data."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            names = re.findall(r"^[\w.]+$", node.value)
        else:
            continue
        for name in names:
            assert not forbidden_module(name), (path, name)


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.physics import PhysicsOptions
    from real2sim_eval_tpu_torch.physics.fused_step import make_fused_step_fn
    from real2sim_eval_tpu_torch.renderer import (Camera, RasterConfig,
                                                  rasterize_batch)
    from real2sim_eval_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedEvaluator(None, [0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fused_step_fn(PhysicsOptions())
    for kernel in ("wide", "fine"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rasterize_batch([(Camera(128, 64, 60.0, 60.0, 64.0, 32.0),
                              torch.eye(4)[None])],
                            {"means3D": torch.zeros((1, 1, 3))}, 0,
                            config=RasterConfig(kernel=kernel))
    assert resolve_device("cpu").type == "cpu"


def test_refinement_entry_points_need_the_card_unless_asked(monkeypatch,
                                                             tmp_path):
    import numpy as np

    from real2sim_eval_tpu_torch.experiments.utils import refine_gs
    from real2sim_eval_tpu_torch.renderer import (Camera, rasterize_diff,
                                                  rasterize_diff_views)
    from real2sim_eval_tpu_torch.utils.ply import save_gaussian_ply

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = 4
    scene = (torch.zeros((n, 3)), torch.ones((n, 3)),
             torch.tensor([[1.0, 0, 0, 0]]).expand(n, 4), torch.ones(n),
             torch.zeros((n, 1, 3)))
    cam = Camera(128, 8, 60.0, 60.0, 64.0, 4.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rasterize_diff(cam, torch.eye(4), *scene, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rasterize_diff_views(cam, torch.eye(4)[None], *scene, 0)
    params = {"means3D": np.zeros((n, 3), np.float32),
              "sh_colors": np.zeros((n, 3), np.float32),
              "log_scales": np.zeros((n, 3), np.float32),
              "unnorm_rotations": np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
              "logit_opacities": np.zeros((n, 1), np.float32)}
    k = np.float32([[60, 0, 64], [0, 60, 4], [0, 0, 1]])
    views = (k[None], np.eye(4, dtype=np.float32)[None],
             np.zeros((1, 8, 128, 3), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        refine_gs.refine(params, *views, iters=1)
    save_gaussian_ply(params, tmp_path / "s.ply")
    np.savez(tmp_path / "v.npz", k=views[0], w2c=views[1], images=views[2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        refine_gs.main(["--ply", str(tmp_path / "s.ply"), "--views",
                        str(tmp_path / "v.npz"), "--out",
                        str(tmp_path / "o.ply"), "--iters", "1"])
    _, hist = refine_gs.refine(params, *views, iters=1, device="cpu")
    assert len(hist) == 1 and np.isfinite(hist[0])


def test_config_entry_points_need_the_card_unless_asked(monkeypatch,
                                                        tmp_path):
    """The config-driven entry points (``BatchedEvaluator(cfg, ...)``,
    ``envs.make``, ``BaseEnv``, ``GSRenderer``, ``PhysTwinDynamics``)
    default to the card and raise without one; with ``device="cpu"``
    they build. ``online: true`` builds the live viewer."""
    import real2sim_eval_tpu_torch.envs as envs
    from real2sim_eval_tpu_torch import testing as tt
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.physics.dynamics import PhysTwinDynamics
    from real2sim_eval_tpu_torch.renderer.renderer import GSRenderer

    rope = tt.make_rope_points(n=30, length=0.2)
    tt.write_fixture_checkpoint(tmp_path, "rope", rope, spring_Y=2e3)
    gs = tt.make_synthetic_scene(tmp_path / "scans", rope_pts=rope,
                                 n_table=50)
    cfg = tt.full_cfg(tmp_path, "rope", gs=gs, cameras=tt.TEST_CAMERAS,
                      physics_over=dict(dt=2e-4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda **kw: BatchedEvaluator(cfg.copy(), [0], **kw),
                  lambda **kw: envs.make("BaseEnv-v0", cfg=cfg, **kw),
                  lambda **kw: envs.BaseEnv(cfg, **kw),
                  lambda **kw: GSRenderer(cfg, **kw),
                  lambda **kw: PhysTwinDynamics(cfg, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        assert build(device="cpu") is not None
    online = cfg.copy()
    online.online = True
    online.viser_port = 0                # a free port
    renderer = GSRenderer(online, device="cpu")
    try:
        assert renderer.online and renderer.viser_viewer.port > 0
    finally:
        renderer.viser_viewer.close()


def test_cli_entry_points_need_the_card_unless_asked(monkeypatch, tmp_path):
    """The CLIs (run on the repo's cfg/ tree), ``KinHelper``, the teleop
    playground and the mesh default to the card and raise without one;
    ``KinHelper`` and the playground build with ``device="cpu"``."""
    from real2sim_eval_tpu_torch import testing as tt
    from real2sim_eval_tpu_torch.config import load_config
    from real2sim_eval_tpu_torch.experiments import (eval_policy,
                                                     eval_policy_batched,
                                                     eval_policy_parallel,
                                                     replay)
    from real2sim_eval_tpu_torch.experiments.keyboard_teleop import (
        InteractivePlayground)
    from real2sim_eval_tpu_torch.kinematics import KinHelper
    from real2sim_eval_tpu_torch.parallel import make_env_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.chdir(tmp_path)      # a run would write under log/
    for mod in (eval_policy, eval_policy_batched, eval_policy_parallel,
                replay):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.cli([])
    assert not (tmp_path / "log").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KinHelper(tt.BUILTIN_URDF)
    cfg = load_config(REPO / "cfg", "keyboard_teleop")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InteractivePlayground(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_env_mesh()
    assert KinHelper(tt.BUILTIN_URDF, device="cpu").device.type == "cpu"
    assert InteractivePlayground(cfg, device="cpu").device.type == "cpu"
