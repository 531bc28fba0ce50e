"""The port's single env and its parts against the JAX package's, on the CPU.

Both packages build from the same fixture files (the JAX package's
writers; tests/test_torch_host_assets.py holds the port's writers to
them byte for byte) at a small size: the built-in arm, a rope of 80
particles, a 300-splat table scan with robot splats, the clip mesh, the
64x128 test cameras, dt = 2e-4. The JAX env renders with its dense
reference (``RasterConfig(backend="reference")``), the port's with its
default compositor (K1's plain version on the CPU).

Held: ``PhysTwinDynamics``' params, options and colliders (integer
tables and host arrays bitwise) and the config it rewrites in place;
``BaseEnv`` over reset, ``get_obs`` and two steps in each action mode
(cartesian, velocity control, joint) at the JAX package's tolerances
(particles 5e-5, grippers 1e-5, frames 2e-3 rgb and 1e-3 depth, depth
with test_torch_batched.py's allowance of a few flipped pixels);
``get_state``; the randomization draws, uniform and grid, bitwise, with
numpy's global generator consumed in between and untouched by the port;
the topology cache across two checkpoints; the two gymnasium ids.
That the entry points need the card unless asked is in
test_torch_standalone.py."""

import copy

import numpy as np
import pytest

from real2sim_eval_tpu.testing import (BUILTIN_URDF, TEST_CAMERAS, full_cfg,
                                       make_rope_points, make_synthetic_scene,
                                       write_fixture_checkpoint)

HOLD = np.concatenate([[0.26, 0.02, 0.38], np.diag([1.0, -1.0, -1.0])
                       .reshape(-1), [0.6]])[None].astype(np.float32)
# (action, do_velocity_control) per step: two of each mode
STEPS = [("cartesian", HOLD, False), ("cartesian", HOLD * [[1.02] * 3 + [1] * 10],
                                      False),
         ("velocity", HOLD, True), ("velocity", HOLD, True),
         ("joint", np.array([[0.0, -0.7, 0.0, 0.55, 0.0, 1.25, 0.0, 0.2]],
                            np.float32), False),
         ("joint", np.array([[0.05, -0.75, 0.0, 0.6, 0.0, 1.3, 0.02, 0.3]],
                            np.float32), False)]


def _scene(root, case, n=80, grid=True, seed=0):
    rope = make_rope_points(n=n, length=0.3, seed=seed)
    write_fixture_checkpoint(root, case, rope, spring_Y=2e3)
    gs = make_synthetic_scene(root / f"scans_{case}", rope_pts=rope,
                              ik_urdf=BUILTIN_URDF, n_table=300)
    gs["use_grid_randomization"] = grid
    return full_cfg(root, case, gs=gs, cameras=TEST_CAMERAS,
                    physics_over=dict(dt=2e-4, self_collision=True))


def _to_port_cfg(cfg):
    from real2sim_eval_tpu_torch.config import ConfigNode
    return ConfigNode(copy.deepcopy(cfg.to_dict()))


def _envs(cfg, randomize=True):
    import real2sim_eval_tpu.envs as jenvs
    from real2sim_eval_tpu.renderer import RasterConfig as JRC
    import real2sim_eval_tpu_torch.envs as tenvs

    jcfg, tcfg = copy.deepcopy(cfg), _to_port_cfg(cfg)
    jenv = jenvs.make("BaseEnv-v0", cfg=jcfg, randomize=randomize,
                      raster_config=JRC(backend="reference"))
    tenv = tenvs.make("BaseEnv-v0", cfg=tcfg, randomize=randomize,
                      device="cpu")
    return jenv, tenv


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("env")
    return root, _scene(root, "rope_env")


def _frames_close(t_obs, j_obs):
    for key, tol in (("image_list", 2e-3), ("depth_list", 1e-3),
                     ("image_wrist_list", 2e-3), ("depth_wrist_list", 1e-3)):
        assert len(t_obs[key]) == len(j_obs[key]) == 1, key
        tv, jv = t_obs[key][0].numpy(), np.asarray(j_obs[key][0])
        assert tv.shape == jv.shape and np.isfinite(tv).all(), key
        if key.startswith("image"):
            assert jv.max() > 0.05, key          # the frame shows the scene
            np.testing.assert_allclose(tv, jv, atol=tol, err_msg=key)
        else:
            # a pixel whose last splat sits at the alpha threshold may flip
            # between the packages (tests/test_torch_batched.py's allowance)
            flips = int((np.abs(tv - jv) > tol).sum())
            assert flips <= max(5, int(2e-4 * tv.size)), (key, flips)
    for k in ("eef_xyz", "eef_quat", "eef_gripper"):
        np.testing.assert_allclose(t_obs["robot"][k],
                                   np.asarray(j_obs["robot"][k]), atol=1e-5)


@pytest.fixture(scope="module")
def episode(scene):
    """Both envs reset on seed 3, then stepped through STEPS; the
    observations and states after the reset and after every step."""
    _, cfg = scene
    jenv, tenv = _envs(cfg)
    jobs, _ = jenv.reset(seed=3)
    tobs, _ = tenv.reset(seed=3)
    trace = [("reset", jobs, tobs, _snap(jenv, tenv))]
    for mode, action, dvc in STEPS:
        jenv.step({"action": action, "do_velocity_control": dvc})
        tenv.step({"action": action, "do_velocity_control": dvc})
        trace.append((mode, jenv.unwrapped.get_obs(),
                      tenv.unwrapped.get_obs(), _snap(jenv, tenv)))
    return jenv, tenv, trace


def _snap(jenv, tenv):
    j, t = jenv.unwrapped, tenv.unwrapped
    return (np.asarray(j.physics.current_points),
            t.physics.current_points.numpy(),
            j.renderer.grippers.copy(), t.renderer.grippers.copy())


def test_dynamics_params_match(episode, scene):
    jenv, tenv, _ = episode
    jp, tp = jenv.unwrapped.physics, tenv.unwrapped.physics
    for name in ("springs", "nbr_idx", "collision_mask", "cand_invalid"):
        np.testing.assert_array_equal(getattr(tp.params, name).numpy(),
                                      np.asarray(getattr(jp.params, name)))
        assert (getattr(tp.params, name).numpy().dtype
                == np.asarray(getattr(jp.params, name)).dtype), name
    for name in ("rest_lengths", "spring_Y_log", "masses", "nbr_rest",
                 "nbr_Y_log", "collide_elas", "collide_fric",
                 "collide_eef_elas", "collide_eef_fric", "collide_self_elas",
                 "collide_self_fric"):
        np.testing.assert_array_equal(getattr(tp.params, name).numpy(),
                                      np.asarray(getattr(jp.params, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tp.params.rest_x.numpy(),
                                  np.asarray(jp.params.rest_x))
    for k in tp.host_cache:
        np.testing.assert_array_equal(tp.host_cache[k], jp.host_cache[k])
    jo = jp.opts
    for f in ("dt", "num_substeps", "fps", "dashpot_damping", "drag_damping",
              "spring_Y_min", "spring_Y_max", "collision_dist",
              "reverse_factor", "self_collision", "use_pusher", "n_fingers"):
        assert getattr(tp.opts, f) == getattr(jo, f), f
    np.testing.assert_array_equal(tp.colliders.finger_pose_table.numpy(),
                                  np.asarray(jp.colliders.finger_pose_table))
    np.testing.assert_array_equal(tp.colliders.static_pose.numpy(),
                                  np.asarray(jp.colliders.static_pose))
    for tg, jg in zip(tp.colliders.fingers + tp.colliders.statics,
                      jp.colliders.fingers + jp.colliders.statics):
        np.testing.assert_array_equal(tg.values.numpy(), np.asarray(jg.values))
        np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    np.testing.assert_array_equal(tp.finger_centroids.numpy(),
                                  np.asarray(jp.finger_centroids))
    np.testing.assert_array_equal(tp.global_translation, jp.global_translation)
    np.testing.assert_array_equal(tp.init_spring_Y.numpy(),
                                  np.asarray(jp.init_spring_Y))
    # the config rewritten in place by the build: checkpoint parameters,
    # num_substeps = round(1 / fps / dt)
    assert tenv.unwrapped.cfg.to_dict() == jenv.unwrapped.cfg.to_dict()
    assert tenv.unwrapped.cfg.physics.num_substeps == 167
    assert tenv.unwrapped.cfg.to_dict() != scene[1].to_dict()


def test_pusher_sets_eef_friction(scene):
    """The pusher branch rewrites collide_eef_fric as the JAX one does."""
    import real2sim_eval_tpu.envs as jenvs
    import real2sim_eval_tpu_torch.envs as tenvs

    root, cfg = scene
    cfg = copy.deepcopy(cfg)
    cfg.env.robot.use_pusher = True
    jcfg, tcfg = copy.deepcopy(cfg), _to_port_cfg(cfg)
    jenvs.make("BaseEnv-v0", cfg=jcfg).reset(seed=0,
                                             options={"skip_obs": True})
    tenvs.make("BaseEnv-v0", cfg=tcfg, device="cpu").reset(
        seed=0, options={"skip_obs": True})
    assert tcfg.physics.collide_eef_fric == 0.2
    assert tcfg.to_dict() == jcfg.to_dict()


@pytest.mark.parametrize("i", range(len(STEPS) + 1),
                         ids=["reset"] + [f"{m}{k}" for k, (m, _, _)
                                          in enumerate(STEPS)])
def test_env_tracks_jax(episode, i):
    _, _, trace = episode
    mode, jobs, tobs, (jx, tx, jg, tg) = trace[i]
    assert np.isfinite(tx).all()
    np.testing.assert_allclose(tx, jx, atol=5e-5)
    np.testing.assert_allclose(tg, jg, atol=1e-5)
    _frames_close(tobs, jobs)
    if i:
        # the step moved something
        assert np.abs(tx - trace[0][3][1]).max() > 0.0


def test_kin_adapter_ik_matches(episode):
    """The kin_helper the env hands its physics: the same chain, and an IK
    toward an x, y, z + static-xyz Euler target that lands where the JAX
    one lands."""
    from real2sim_eval_tpu.envs.base_env import _KinAdapter as JKin
    from real2sim_eval_tpu_torch.envs.base_env import _KinAdapter as TKin

    jenv, tenv, _ = episode
    jk, tk = JKin(jenv.unwrapped.renderer), TKin(tenv.unwrapped.renderer)
    assert tk.chain.link_names == jk.chain.link_names
    q0 = np.array([0, -45, 0, 30, 0, 75, 0]) * np.pi / 180.0
    cart = np.array([0.27, 0.03, 0.36, np.pi, 0.05, -0.1])
    qt, qj = tk.compute_ik_sapien(q0, cart), np.asarray(
        jk.compute_ik_sapien(q0, cart))
    assert qt.shape == qj.shape == (7,)
    np.testing.assert_allclose(qt, qj, atol=1e-4)
    fk = tenv.unwrapped.renderer.compute_fk(qt[None])[0]
    np.testing.assert_allclose(fk[0], cart[:3], atol=1e-2)


def test_get_state_matches(episode):
    jenv, tenv, _ = episode
    js, ts = jenv.unwrapped.get_state(), tenv.unwrapped.get_state()
    np.testing.assert_allclose(ts["renderer"]["x"], js["renderer"]["x"],
                               atol=5e-5)
    np.testing.assert_array_equal(ts["physics"]["init_springs"],
                                  js["physics"]["init_springs"])
    assert len(ts["physics"]["static_meshes"]) == 1
    for a, b in zip(ts["physics"]["static_meshes"],
                    js["physics"]["static_meshes"]):
        np.testing.assert_array_equal(a["vertices"], b["vertices"])
        np.testing.assert_array_equal(a["faces"], b["faces"])
    jst = jenv.unwrapped.physics.get_state()
    tst = tenv.unwrapped.physics.get_state()
    for k in ("init_springs", "init_rest_lengths", "init_spring_Y"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))


@pytest.mark.parametrize("grid", [False, True], ids=["uniform", "grid"])
def test_random_variables_bitwise(tmp_path, grid):
    """The episodes' randomization draws equal the JAX package's bitwise,
    single env and evaluator, with numpy's global generator consumed in
    between; the port's resets leave that generator as they found it."""
    from real2sim_eval_tpu.parallel import BatchedEvaluator as JEval
    from real2sim_eval_tpu.renderer import RasterConfig as JRC
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator as TEval

    cfg = _scene(tmp_path, "rope_rand", n=40, grid=grid)
    jenv, tenv = _envs(cfg)
    for seed in (0, 5, 11):
        jenv.reset(seed=seed, options={"skip_obs": True})
        np.random.uniform(size=7)            # someone else draws
        before = np.random.get_state()[1].copy()
        tenv.reset(seed=seed, options={"skip_obs": True})
        np.testing.assert_array_equal(np.random.get_state()[1], before)
        jr = jenv.unwrapped.renderer.random_variables
        tr = tenv.unwrapped.renderer.random_variables
        assert tr == jr and len(tr) == (1 if grid else 2)
        np.testing.assert_array_equal(tenv.unwrapped.renderer.pose_obj_np,
                                      jenv.unwrapped.renderer.pose_obj_np)
    ids = [0, 4, 7]
    jev = JEval(copy.deepcopy(cfg), ids, raster_config=JRC(backend="reference"),
                physics_backend="xla")
    np.random.uniform(size=3)
    tev = TEval(_to_port_cfg(cfg), ids, device="cpu")
    assert tev.random_variables == jev.random_variables
    np.testing.assert_array_equal(tev.state.rel_pose.numpy(),
                                  np.asarray(jev.state.rel_pose))


def test_topology_cache_per_checkpoint(tmp_path):
    """Two checkpoints in one process keep their own springs (the
    topology cache is keyed by checkpoint, as the JAX package keys it)."""
    from real2sim_eval_tpu_torch.physics.dynamics import PhysTwinDynamics

    springs = []
    for case, n, seed in (("rope_a", 40, 0), ("rope_b", 55, 1)):
        cfg = _scene(tmp_path, case, n=n, seed=seed)
        jenv, tenv = _envs(cfg, randomize=False)
        for env in (jenv, tenv):
            env.reset(seed=0, options={"skip_obs": True})
        tsp = tenv.unwrapped.physics.params.springs.numpy()
        np.testing.assert_array_equal(
            tsp, np.asarray(jenv.unwrapped.physics.params.springs))
        springs.append(tsp)
    assert springs[0].shape != springs[1].shape
    keys = [k for k in PhysTwinDynamics._topology_cache
            if k[1] in ("rope_a", "rope_b")]
    assert len(keys) == 2


def test_gym_ids_resolve_to_each_package(scene):
    """Both packages in one process: "BaseEnv-v0" is the JAX package's
    gymnasium id, the port registers its own namespaced id, and each
    package's ``envs.make`` resolves its own class."""
    import gymnasium as gym

    import real2sim_eval_tpu.envs as jenvs
    import real2sim_eval_tpu_torch.envs as tenvs
    from real2sim_eval_tpu.renderer import RasterConfig as JRC

    _, cfg = scene
    jgym = gym.make("BaseEnv-v0", cfg=copy.deepcopy(cfg),
                    raster_config=JRC(backend="reference"))
    tgym = gym.make("real2sim_eval_tpu_torch/BaseEnv-v0",
                    cfg=_to_port_cfg(cfg), device="cpu")
    assert type(jgym.unwrapped) is jenvs.BaseEnv
    assert type(tgym.unwrapped) is tenvs.BaseEnv
    assert tenvs.REGISTERED_ENVS["BaseEnv-v0"].cls is tenvs.BaseEnv
    assert jenvs.REGISTERED_ENVS["BaseEnv-v0"].cls is jenvs.BaseEnv
    env = tenvs.make("BaseEnv-v0", max_episode_steps=1, cfg=_to_port_cfg(cfg),
                     device="cpu")
    assert type(env.unwrapped) is tenvs.BaseEnv
    env.reset(seed=0)
    assert env.step({"action": HOLD})[3] is True     # truncated at the limit
