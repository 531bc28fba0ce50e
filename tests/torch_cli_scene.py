"""The small scene and config the port's CLI tests share, written by the
port's fixture writers (byte-identical files to the JAX writers'): the
built-in arm, a rope of 100 particles, a 300-splat table scan, the 64x128
test cameras (one fixed, one wrist), duration 1 (30 control steps after
30 stabilization steps), dt = 2e-4 without self-collision, the hold
policy and ``raster_backend: auto`` (the JAX package's dense reference
on the CPU, the port's tile compositor)."""

import contextlib
import json

import numpy as np
import torch

from real2sim_eval_tpu_torch import testing as tt

STEPS = 30


def write_cfg(root, case="rope_cli", **top):
    rope = tt.make_rope_points(n=100, length=0.3)
    tt.write_fixture_checkpoint(root, case, rope, spring_Y=2e3)
    gs = tt.make_synthetic_scene(root / f"scans_{case}", rope_pts=rope,
                                 ik_urdf=tt.BUILTIN_URDF, n_table=300)
    cfg = tt.full_cfg(root, case, gs=gs, cameras=tt.TEST_CAMERAS,
                      physics_over=dict(dt=2e-4, self_collision=False))
    cfg.exp_root = str(root / "log")
    cfg.raster_backend = "auto"
    cfg.timestamp = "run"
    cfg.env.sim.duration = 1
    for k, v in top.items():
        cfg[k] = v
    return cfg


def write_descent(gt, n_steps, descent=0.005):
    """A recorded trajectory from the configured initial eef, each frame
    ``descent`` lower, pointing down, the gripper open, in the ``ee_pos``
    format with the port's ``KinHelper`` IK as ``action.qpos`` beside it."""
    from real2sim_eval_tpu_torch.kinematics import KinHelper
    from real2sim_eval_tpu_torch.kinematics.robot import CANONICAL_ARM_QPOS

    kh = KinHelper(tt.BUILTIN_URDF, device="cpu")
    q = CANONICAL_ARM_QPOS.astype(np.float32)
    (gt / "robot").mkdir(parents=True)
    for i in range(n_steps):
        xyz = [0.2568, 0.0, 0.4005 - descent * i]
        q = kh.compute_ik_sapien(q, np.array(xyz + [np.pi, 0.0, 0.0]))
        rec = {"action.ee_pos": xyz, "action.ee_quat": [0.0, 1.0, 0.0, 0.0],
               "action.gripper_qpos": [0.0], "action.qpos": q.tolist()}
        with open(gt / "robot" / f"{i:06d}.json", "w") as f:
            json.dump(rec, f)


@contextlib.contextmanager
def one_thread():
    """Run torch on one host thread: the CLIs' ops are small, and the
    suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def files(run):
    return sorted(str(p.relative_to(run)) for p in run.rglob("*")
                  if p.is_file())


def assert_runs_match(jax_run, port_run, n_steps):
    """The same files; ``renderer.x`` within 5e-5 at every step; robot
    JSONs (the eef among them) within 1e-5; random variables and
    calibration equal."""
    import pickle

    names = files(jax_run)
    assert names == files(port_run)
    assert sum(n.endswith(".pkl") for n in names) == n_steps
    for f in names:
        a, b = jax_run / f, port_run / f
        if f.endswith(".pkl"):
            sa, sb = (pickle.load(open(p, "rb")) for p in (a, b))
            assert sa.keys() == sb.keys(), f
            xb = sb["renderer"]["x"].numpy()
            assert np.isfinite(xb).all(), f
            np.testing.assert_allclose(xb, sa["renderer"]["x"].numpy(),
                                       atol=5e-5, err_msg=f)
        elif "/robot/" in f:
            ja, jb = json.load(open(a)), json.load(open(b))
            assert ja.keys() == jb.keys(), f
            for k in ja:
                np.testing.assert_allclose(jb[k], ja[k], atol=1e-5,
                                           err_msg=f)
        elif f.endswith("random_variables.json"):
            assert json.load(open(a)) == json.load(open(b)), f
        elif "/calibration/" in f:
            assert a.read_bytes() == b.read_bytes(), f
