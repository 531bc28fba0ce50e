"""The whole slice: the port's BatchedEvaluator against the JAX one.

The JAX evaluator is built as bench.py builds it, at a small size: B=2, a
rope of 120 particles, a 400-splat table scan with robot splats on the
built-in arm, the 64x128 test cameras (one fixed, one wrist), dt=2e-4 and
self-collision on. It runs its plain references of both kernels
(``physics_backend="xla"``, ``RasterConfig(backend="reference")``). Its
assets are carried across as numpy arrays (``convert.assets_from_numpy``),
both evaluators take two velocity-controlled steps and render, and the
states and frames are compared at the JAX package's own tolerances
(tests/test_batched.py: particles 5e-5, grippers 1e-5). The port renders
on each of its branches: the full pipeline (``incremental="off"``), the
incremental one with either merge (sort + K2, stream K6), the fine family
(``kernel="fine"``: K5 for the fixed cameras, K4 for the wrist), the
wide fixed cameras with a fine wrist (``wrist_kernel="fine"``) and the
per-env branch of the dense reference (``backend="reference"``); the
per-env branch also renders a wrist camera of another resolution. Frames of
the fine family are held to a JAX evaluator of the same state with
``RasterConfig(backend="reference", kernel="fine")``, whose dense
reference gates at the fine tiles too."""

import dataclasses

import numpy as np
import pytest

from real2sim_eval_tpu.testing import (BUILTIN_URDF, TEST_CAMERAS, full_cfg,
                                       make_rope_points, make_synthetic_scene,
                                       write_fixture_checkpoint)
from real2sim_eval_tpu_torch.convert import assets_from_numpy
from real2sim_eval_tpu_torch.renderer import RasterConfig

EPISODES = [0, 4]
# the port's render branches: incremental off, or on with either merge,
# on the fine family, or with the wrist camera alone on it
BRANCHES = {"off": RasterConfig(incremental="off"),
            "sort": RasterConfig(incremental="on", merge_kernel="sort"),
            "stream": RasterConfig(incremental="on", merge_kernel="stream"),
            "fine": RasterConfig(incremental="on", kernel="fine"),
            "wrist_fine": RasterConfig(incremental="on",
                                       wrist_kernel="fine"),
            "reference": RasterConfig(backend="reference")}
# the kernel family of the (fixed, wrist) frames of each branch
FAMILIES = {"off": ("wide", "wide"), "sort": ("wide", "wide"),
            "stream": ("wide", "wide"), "fine": ("fine", "fine"),
            "wrist_fine": ("wide", "fine"), "reference": ("wide", "wide")}


def jax_assets_tree(ev) -> dict:
    """Flat numpy dict of everything the JAX evaluator set up."""
    tree = {}
    for f in dataclasses.fields(ev.params):
        v = getattr(ev.params, f.name)
        if f.name in ("springs", "rest_lengths", "spring_Y_log", "masses",
                      "nbr_idx", "nbr_rest", "nbr_Y_log", "collision_mask",
                      "rest_x", "cand_invalid") or f.name.startswith("collide"):
            if v is not None:
                tree[f"params/{f.name}"] = np.asarray(v)
    tree.update({f"opts/{k}": v
                 for k, v in dataclasses.asdict(ev.opts).items()})
    c = ev.colliders
    for kind, grids in (("fingers", c.fingers), ("statics", c.statics)):
        for i, g in enumerate(grids):
            for k in ("origin", "inv_spacing", "values"):
                tree[f"colliders/{kind}/{i}/{k}"] = np.asarray(getattr(g, k))
    tree["colliders/finger_pose_table"] = np.asarray(c.finger_pose_table)
    for name, arrs in (("obj", dict(means3D=ev.obj_means0,
                                    rotations=ev.obj_quats0, shs=ev.obj_shs,
                                    scales=ev.obj_scales,
                                    opacities=ev.obj_opac)),
                       ("table", ev.table)):
        tree.update({f"{name}/{k}": np.asarray(v) for k, v in arrs.items()})
    for mname, pm in ev.mesh_params.items():
        tree.update({f"mesh_params/{mname}/{k}": np.asarray(v)
                     for k, v in pm.items()})
    for key, cams, ext in (("cameras", ev.cameras, "w2c"),
                           ("wrist_cameras", ev.wrist_cameras, "eef2c")):
        for i, (w, h, k, e) in enumerate(cams):
            tree.update({f"{key}/{i}/w": w, f"{key}/{i}/h": h,
                         f"{key}/{i}/K": np.asarray(k),
                         f"{key}/{i}/{ext}": np.asarray(e)})
    ch = ev._chain
    tree["chain/link_names"] = np.asarray(ch.link_names)
    for k in ("parent", "joint_type", "origins", "axes", "dof_index",
              "n_dof", "topo_order", "lower", "upper"):
        tree[f"chain/{k}"] = np.asarray(getattr(ch, k))
    art = ev.articulation
    tree.update({"articulation/link_ids": np.asarray(art.link_ids),
                 "articulation/base_inv": np.asarray(art.base_inv),
                 "articulation/offsets": np.asarray(art.offsets),
                 "articulation/active": np.asarray(art.active),
                 "articulation/use_pusher": art.use_pusher})
    st = ev.state
    tree.update({
        "finger_centroids": np.asarray(ev.finger_centroids),
        "global_translation": np.asarray(ev.global_translation),
        "force_threshold": ev.force_threshold, "fps": ev._fps,
        "use_shs": ev.use_shs,
        "do_velocity_control": bool(ev.cfg.env.robot.do_velocity_control),
        "qpos0": np.asarray(ev._qpos0, np.float32),
        "bones0": np.asarray(ev.bones0), "mask": np.asarray(ev.mask),
        "state/x": np.asarray(st.sm.x), "state/v": np.asarray(st.sm.v),
        "state/finger_forces": np.asarray(st.sm.finger_forces),
        "state/telemetry": np.asarray(st.sm.telemetry),
        "state/current_openness": np.asarray(st.grasp.current_openness),
        "state/grasped": np.asarray(st.grasp.grasped),
        "state/initialized": np.asarray(st.grasp.initialized),
        "state/grippers": np.asarray(st.grippers),
        "state/qpos7": np.asarray(st.qpos7),
        "state/rel_pose": np.asarray(st.rel_pose),
        "state/static_pose": np.asarray(st.static_pose),
        "state/rest_x": np.asarray(st.rest_x), "state/step": int(st.step),
    })
    return tree


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    from real2sim_eval_tpu.parallel import BatchedEvaluator as JEval
    from real2sim_eval_tpu.renderer import RasterConfig as JRC
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator as TEval

    root = tmp_path_factory.mktemp("slice")
    rope = make_rope_points(n=120, length=0.3)
    write_fixture_checkpoint(root, "rope_slice", rope, spring_Y=2e3)
    gs = make_synthetic_scene(root / "scans", rope_pts=rope,
                              ik_urdf=BUILTIN_URDF, n_table=400)
    gs["use_grid_randomization"] = True
    cfg = full_cfg(root, "rope_slice", gs=gs, cameras=TEST_CAMERAS,
                   physics_over=dict(dt=2e-4, self_collision=True))
    jev = JEval(cfg, episode_ids=EPISODES,
                raster_config=JRC(backend="reference"), physics_backend="xla")
    # the tree of the evaluator as built, before any test steps it
    jev.initial_tree = jax_assets_tree(jev)
    tev = TEval(assets_from_numpy(jev.initial_tree, "cpu"), EPISODES,
                device="cpu")
    return jev, tev


def hold_then_reach_actions(B):
    rot = np.diag([1.0, -1.0, -1.0]).reshape(-1)
    a = np.concatenate([[0.26, 0.02, 0.38], rot, [0.6]])
    return np.tile(a, (B, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def stepped(evaluators):
    """Both evaluators after two steps; the JAX frames of the state after
    them and the JAX state after that render."""
    import jax.numpy as jnp

    jev, tev = evaluators
    acts = hold_then_reach_actions(len(EPISODES))
    for _ in range(2):
        jev.step(jnp.asarray(acts))
        tev.step(acts)
    js, ts = jev.state, tev.state
    j_out = jev.render()
    return jev, tev, js, ts, j_out, jev.state


@pytest.fixture(scope="module")
def jax_fine_frames(stepped):
    """The JAX frames of the stepped state rendered by the dense reference
    gated at the fine tiles (``kernel="fine"``)."""
    from real2sim_eval_tpu.parallel import BatchedEvaluator as JEval
    from real2sim_eval_tpu.renderer import RasterConfig as JRC

    jev, _, js, _, _, _ = stepped
    jf = JEval(jev.cfg, episode_ids=EPISODES,
               raster_config=JRC(backend="reference", kernel="fine"),
               physics_backend="xla")
    jf.state = js
    return jf.render()


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_whole_slice_matches_jax(stepped, jax_fine_frames, branch):
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator as TEval

    jev, tev0, js, ts, j_wide, js_rendered = stepped
    fam = {"wide": j_wide, "fine": jax_fine_frames}
    fixed, wrist = FAMILIES[branch]
    j_out = fam[fixed][:2] + fam[wrist][2:4]
    tev = TEval(tev0.assets, EPISODES, raster_config=BRANCHES[branch],
                device="cpu")
    assert tev.incremental == (branch not in ("off", "reference"))
    assert tev.per_env == (branch == "reference")
    tev.state = ts
    assert np.isfinite(ts.sm.x.numpy()).all()
    np.testing.assert_allclose(ts.sm.x.numpy(), np.asarray(js.sm.x),
                               atol=5e-5)
    np.testing.assert_allclose(ts.grippers.numpy(), np.asarray(js.grippers),
                               atol=1e-5)
    np.testing.assert_allclose(ts.qpos7.numpy(), np.asarray(js.qpos7),
                               atol=1e-4)
    np.testing.assert_array_equal(ts.sm.telemetry.numpy()[:, :3],
                                  np.asarray(js.sm.telemetry)[:, :3])
    assert tev.telemetry()["patch_escapes"].sum() == 0
    np.testing.assert_allclose(tev.particle_states(), jev.particle_states(),
                               atol=5e-5)

    t_out = tev.render()
    for (name, jv), tv in zip((("fixed rgb", j_out[0]),
                               ("fixed depth", j_out[1]),
                               ("wrist rgb", j_out[2]),
                               ("wrist depth", j_out[3])), t_out):
        jv, tv = np.asarray(jv), tv.numpy()
        assert tv.shape == jv.shape, name
        if "rgb" in name:
            assert jv.max() > 0.05, name       # the frame shows the scene
            np.testing.assert_allclose(tv, jv, atol=2e-3, err_msg=name)
        else:
            flips = int((np.abs(tv - jv) > 1e-2).sum())
            assert flips <= max(5, int(2e-4 * tv.size)), (name, flips)
    np.testing.assert_allclose(tev.state.qpos7.numpy(),
                               np.asarray(js_rendered.qpos7), atol=1e-4)
    if tev.incremental:
        n_dirty = tev.render_telemetry[0][..., 0]
        assert (n_dirty > 0).all() and (n_dirty < 8).all()
        if fixed == "fine":
            n_fine = tev.render_stats["dirty_fine_tiles"]
            assert ((n_dirty <= n_fine) & (n_fine <= 8 * n_dirty)).all()
    assert tev.render_drops() == {"fixed_dropped_tiles": 0,
                                  "fixed_dropped_pairs": 0,
                                  "fixed_binning_dropped": 0,
                                  "wrist_binning_dropped": 0}
    obs = tev.observations()
    assert obs["observation.state"].shape == (len(EPISODES), 8)
    assert obs["images"].shape == (len(EPISODES), 1, 3, 64, 128)
    scenes = tev.compose_scenes()
    assert scenes["means3D"].shape[1] == scenes["shs"].shape[1]


def test_wrist_kernel_changes_only_the_wrist_family(stepped):
    """tests/test_wrist_kernel.py: ``wrist_kernel="fine"`` renders the
    wrist camera with the fine family and leaves the fixed cameras' wide
    frames as they are (bitwise); the wrist frames change, within the JAX
    suite's bound between the families (2e-2 rgb, 1e-2 depth)."""
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator as TEval

    _, tev0, _, ts, _, _ = stepped
    outs = {}
    for branch in ("sort", "wrist_fine"):
        tev = TEval(tev0.assets, EPISODES, raster_config=BRANCHES[branch],
                    device="cpu")
        tev.state = ts
        outs[branch] = [o.numpy() for o in tev.render()]
    for i in (0, 1):
        np.testing.assert_array_equal(outs["wrist_fine"][i], outs["sort"][i])
    d_rgb = np.abs(outs["wrist_fine"][2] - outs["sort"][2]).max()
    d_dep = np.abs(outs["wrist_fine"][3] - outs["sort"][3]).max()
    assert 0.0 < d_rgb < 2e-2 and d_dep < 1e-2, (d_rgb, d_dep)


def test_degree3_scene_renders(evaluators):
    """The evaluator's ``use_shs`` branch on a degree-3 scene (what every
    real 3DGS PLY carries): the slice's scene with its SH lifted to 16
    coefficients (the DC kept, higher bands N(0, 0.05^2)) renders on the
    full-pipeline and the incremental branch, the two agree, and the view
    direction changes the frames."""
    import torch

    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator as TEval

    _, tev0 = evaluators
    rng = np.random.default_rng(0)

    def lift(s):
        hi = rng.normal(scale=0.05, size=(s["shs"].shape[0], 15, 3))
        return dict(s, shs=torch.cat([s["shs"][:, :1], torch.as_tensor(
            hi, dtype=torch.float32)], dim=1))

    a0 = tev0.assets
    a3 = dataclasses.replace(
        a0, use_shs=True, obj=lift(a0.obj), table=lift(a0.table),
        mesh_params={k: lift(v) for k, v in a0.mesh_params.items()})
    outs = {}
    for branch in ("off", "sort"):
        tev = TEval(a3, EPISODES, raster_config=BRANCHES[branch],
                    device="cpu")
        assert tev.sh_deg == 3
        outs[branch] = [o.numpy() for o in tev.render()]
        assert all(np.isfinite(o).all() for o in outs[branch])
    dc = TEval(a0, EPISODES, raster_config=BRANCHES["off"],
               device="cpu").render()
    for i in (0, 2):                               # fixed and wrist rgb
        np.testing.assert_allclose(outs["sort"][i], outs["off"][i],
                                   atol=2e-3)
        assert np.abs(outs["off"][i] - dc[i].numpy()).max() > 1e-3


def test_wrist_precull_is_pixel_exact(tmp_path):
    """tests/test_precull.py:192's wide floor (4000 splats over 3.5 x 4 m):
    the wrist frames of the port's incremental branch with the cull forced
    on equal those with it off bitwise, and the cull keeps fewer blocks
    than the scene has."""
    from real2sim_eval_tpu.parallel import BatchedEvaluator as JEval
    from real2sim_eval_tpu.renderer import RasterConfig as JRC
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator as TEval

    rope = make_rope_points(n=60, length=0.3)
    write_fixture_checkpoint(tmp_path, "rope_floor", rope, spring_Y=2e3)
    gs = make_synthetic_scene(tmp_path / "scans", rope_pts=rope,
                              ik_urdf=None, n_table=4000,
                              table_extent=((-1.5, 2.0), (-2.0, 2.0)))
    cfg = full_cfg(tmp_path, "rope_floor", gs=gs, cameras=TEST_CAMERAS,
                   physics_over=dict(dt=2e-4, self_collision=False))
    jev = JEval(cfg, episode_ids=[0, 1],
                raster_config=JRC(backend="reference"), physics_backend="xla")
    assets = assets_from_numpy(jax_assets_tree(jev), "cpu")
    outs = {}
    for mode in ("on", "off"):
        ev = TEval(assets, [0, 1], device="cpu", raster_config=RasterConfig(
            incremental="on", wrist_precull=mode))
        _, _, wims, wdeps = ev.render()
        assert sum(ev.render_drops().values()) == 0
        outs[mode] = (wims.numpy(), wdeps.numpy())
        if mode == "on":
            info = ev.wrist_cull
            kept = ev.render_stats["wrist_static_blocks"]
            assert info["static"] and info["cap_blocks"] < info[
                "total_blocks"], info
            assert 0 < int(kept.max()) < info["total_blocks"]
        else:
            assert ev.wrist_cull is None
    assert outs["on"][0].max() > 0.05
    np.testing.assert_array_equal(outs["on"][0], outs["off"][0])
    np.testing.assert_array_equal(outs["on"][1], outs["off"][1])


def test_mixed_resolution_renders_per_env(tmp_path):
    """Cameras of two resolutions (the fixed 64x128 test camera, a 32x96
    wrist camera) take the per-env branch in both packages: the port's
    frames, on the tile pipeline, against the JAX evaluator's dense
    reference of the same state, at the compositor tolerances."""
    from real2sim_eval_tpu.parallel import BatchedEvaluator as JEval
    from real2sim_eval_tpu.renderer import RasterConfig as JRC
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator as TEval

    wrist = dict(TEST_CAMERAS[1], h=32, w=96,
                 intr=[45.0, 0.0, 48.0, 0.0, 45.0, 16.0, 0.0, 0.0, 1.0])
    rope = make_rope_points(n=60, length=0.3)
    write_fixture_checkpoint(tmp_path, "rope_mixed", rope, spring_Y=2e3)
    gs = make_synthetic_scene(tmp_path / "scans", rope_pts=rope,
                              ik_urdf=BUILTIN_URDF, n_table=200)
    cfg = full_cfg(tmp_path, "rope_mixed", gs=gs,
                   cameras=[TEST_CAMERAS[0], wrist],
                   physics_over=dict(dt=2e-4, self_collision=False))
    jev = JEval(cfg, episode_ids=[0, 1],
                raster_config=JRC(backend="reference"), physics_backend="xla")
    tev = TEval(assets_from_numpy(jax_assets_tree(jev), "cpu"), [0, 1],
                device="cpu")
    assert tev.per_env and not tev.incremental
    j_out = jev.render()
    t_out = tev.render()
    for (name, jv), tv in zip((("fixed rgb", j_out[0]),
                               ("fixed depth", j_out[1]),
                               ("wrist rgb", j_out[2]),
                               ("wrist depth", j_out[3])), t_out):
        jv, tv = np.asarray(jv), tv.numpy()
        assert tv.shape == jv.shape, name
        if "rgb" in name:
            assert jv.max() > 0.05, name
            np.testing.assert_allclose(tv, jv, atol=2e-3, err_msg=name)
        else:
            flips = int((np.abs(tv - jv) > 1e-2).sum())
            assert flips <= max(5, int(2e-4 * tv.size)), (name, flips)
    assert t_out[2].shape[-2:] == (32, 96)
    np.testing.assert_allclose(tev.state.qpos7.numpy(),
                               np.asarray(jev.state.qpos7), atol=1e-4)
    assert sum(tev.render_drops().values()) == 0


def test_wrist_cull_counts_belong_to_their_render():
    """The flagship scene, cut small (its "auto" wrist cull stays off): a
    wrist render with the cull forced on reports its kept static blocks,
    and the evaluator's next render, which does not cull, reports none
    rather than the forced render's count."""
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator as TEval
    from real2sim_eval_tpu_torch.testing import make_flagship_assets

    a = make_flagship_assets(batch=1, n_table=15000, n_obj_dense=3880,
                             device="cpu", n_rope=200)
    ev = TEval(a, [0], device="cpu",
               raster_config=RasterConfig(incremental="on"))
    assert ev.wrist_cull["static"] is False
    dyn, _ = ev.compose_dyn(ev.state, dc_only=True)
    ev.render_wrist(ev.state, dyn, True, False)
    kept = ev.render_stats["wrist_static_blocks"]
    assert 0 < int(kept.max()) <= ev.wrist_cull["total_blocks"]
    ev.render()
    assert "wrist_static_blocks" not in ev.render_stats
    assert "wrist_dynamic_blocks" not in ev.render_stats
    assert "merged_pairs" in ev.render_stats


# ---------------------------------------------------------------------------
# the evaluator built from a config
# ---------------------------------------------------------------------------


def _port_cfg(cfg):
    import copy

    from real2sim_eval_tpu_torch.config import ConfigNode
    return ConfigNode(copy.deepcopy(cfg.to_dict()))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_config_build_equals_jax_assets(evaluators, tmp_path, writer):
    """``BatchedEvaluator(cfg, ids)``'s asset build against the JAX
    evaluator's, field by field and bitwise: every array the JAX
    evaluator set up (``jax_assets_tree``) equals the port's, from the
    JAX fixture files or from the port's own writers."""
    from real2sim_eval_tpu_torch import testing as tt
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator as TEval
    from real2sim_eval_tpu_torch.parallel.assets import assets_tree

    jev, _ = evaluators
    if writer == "jax":
        cfg = _port_cfg(jev.cfg)
    else:
        rope = tt.make_rope_points(n=120, length=0.3)
        tt.write_fixture_checkpoint(tmp_path, "rope_slice", rope,
                                    spring_Y=2e3)
        gs = tt.make_synthetic_scene(tmp_path / "scans", rope_pts=rope,
                                     ik_urdf=tt.BUILTIN_URDF, n_table=400)
        gs["use_grid_randomization"] = True
        cfg = tt.full_cfg(tmp_path, "rope_slice", gs=gs,
                          cameras=tt.TEST_CAMERAS,
                          physics_over=dict(dt=2e-4, self_collision=True))
    jt = jev.initial_tree
    tt_tree, rvars, dumps = assets_tree(cfg, EPISODES, device="cpu")
    consumed = {k for k in jt if not k.startswith("opts/")}
    assert consumed <= set(tt_tree), consumed - set(tt_tree)
    for k in sorted(jt):
        if k not in tt_tree:
            continue
        a, b = np.asarray(tt_tree[k]), np.asarray(jt[k])
        if k.startswith("mesh_params/"):
            # the port keeps each lane's mesh splats, at its own episode's
            # mesh pose; this scene's clip does not move, so every lane's
            # are the JAX evaluator's (episode 0's)
            assert a.shape == (len(EPISODES),) + b.shape, k
            b = np.broadcast_to(b, a.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)
        assert a.dtype == b.dtype or a.dtype.kind == b.dtype.kind, k
    assert rvars == jev.random_variables
    for d, j in zip(dumps, jev._static_mesh_dumps):
        np.testing.assert_array_equal(d[0]["vertices"], j[0]["vertices"])
    tev = TEval(cfg, EPISODES, device="cpu")
    assert tev.cfg is cfg and tev.random_variables == jev.random_variables
    if writer == "jax":
        assert cfg.to_dict() == jev.cfg.to_dict()
    np.testing.assert_array_equal(tev.state.rel_pose.numpy(),
                                  np.asarray(jev.state.rel_pose))
    jd, td = jev.get_state_dumps(), tev.get_state_dumps()
    for i, (a, b) in enumerate(zip(td, jd)):
        np.testing.assert_array_equal(
            a["renderer"]["x"], jt["state/x"][i] - jt["global_translation"])
        np.testing.assert_array_equal(a["physics"]["init_springs"],
                                      b["physics"]["init_springs"])
        np.testing.assert_array_equal(
            a["physics"]["static_meshes"][0]["faces"],
            b["physics"]["static_meshes"][0]["faces"])


def test_lane_tracks_single_env(evaluators):
    """A lane of the config-built evaluator against the port's single env
    of the same episode: three steps of the hold action without velocity
    control, particles within the JAX suite's single-versus-batch 1e-4
    (tests/test_batched.py:121); the fixed frames at the compositor
    tolerances before and after the first step. From the second step on
    the two renders part in both packages alike: the single env blends
    the last step's particle motion onto the rest splats
    (renderer/renderer.py ``update_rendervar``: bones = the previous
    particles), the evaluator the motion from the rest bones. So every
    step's frames are also held, at the same tolerances, to the
    evaluator's composition from its pre-render state with the single
    env's blend: rest bones swapped for the env's previous particles,
    particles for the env's current ones."""
    import real2sim_eval_tpu_torch.envs as tenvs
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator as TEval

    jev, _ = evaluators
    ev = TEval(_port_cfg(jev.cfg), [3], RasterConfig(incremental="off"),
               device="cpu")
    env = tenvs.make("BaseEnv-v0", cfg=_port_cfg(jev.cfg), randomize=True,
                     device="cpu")
    obs, _ = env.reset(seed=3)
    act = hold_then_reach_actions(1)
    base_assets = ev.assets

    def assert_frames(frames, obs):
        ims, depths, _, _ = frames
        np.testing.assert_allclose(ims[0, 0].numpy(),
                                   obs["image_list"][0].numpy(), atol=2e-3)
        dd = np.abs(depths[0, 0].numpy() - obs["depth_list"][0].numpy())
        assert int((dd > 1e-3).sum()) <= max(5, int(2e-4 * dd.size))

    for k in range(4):
        bones_prev = env.unwrapped.renderer.state["x"].clone()
        if k:
            ev.step(act, do_velocity_control=False)
            env.step({"action": act, "do_velocity_control": False})
            obs = env.unwrapped.get_obs()
        np.testing.assert_allclose(
            ev.particle_states()[0],
            env.unwrapped.physics.current_points.numpy(), atol=1e-4)
        if k:
            pre = ev.state
            ev.assets = dataclasses.replace(base_assets, bones0=bones_prev)
            ev.state = pre.replace(sm=dataclasses.replace(
                pre.sm, x=env.unwrapped.renderer.state["x"][None]))
            assert_frames(ev.render(), obs)
            ev.assets, ev.state = base_assets, pre
        if k <= 1:
            assert_frames(ev.render(), obs)


def test_save_load_state_round_trip(stepped, tmp_path):
    """A snapshot of the stepped state restores bitwise, and refuses a
    different episode list."""
    import torch

    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator as TEval

    _, tev0, _, ts, _, _ = stepped
    tev = TEval(tev0.assets, EPISODES, device="cpu")
    tev.state = ts
    tev.save_state(tmp_path / "snap.pkl", extra={"step": 2})
    fresh = TEval(tev0.assets, EPISODES, device="cpu")
    assert fresh.load_state(tmp_path / "snap.pkl") == {"step": 2}
    for name in ("grippers", "qpos7", "rel_pose", "static_pose", "rest_x"):
        assert torch.equal(getattr(fresh.state, name), getattr(ts, name))
    for part in ("sm", "grasp"):
        a, b = getattr(fresh.state, part), getattr(ts, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
    assert fresh.state.step == ts.step
    other = TEval(tev0.assets, EPISODES, device="cpu")
    other.episode_ids = [1, 2]
    with pytest.raises(ValueError):
        other.load_state(tmp_path / "snap.pkl")
