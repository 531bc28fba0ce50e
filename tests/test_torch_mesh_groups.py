"""A scene whose attached mesh moves per episode (sloth packing's box) on
the port's batched path, on the CPU.

Held: on a tiny sloth-shaped scene (a solid of a few hundred particles, a
small open container, 2 one-to-one object cells x 2 one-to-one container
cells, 4 lanes) each lane's mesh splats are bit for bit those of a
one-episode build of its episode, and its frames lie within the compositor
tolerances (2e-3 rgb, 1e-3 depth) of that build's, on the full pipeline and
on the incremental branch with the wrist pre-cull on (wide and fine
kernel families); with one mesh pose
the evaluator keeps one group and its frames are bitwise those of the
shared (broadcast) mesh layout; the written container's SDF matches the
JAX package's inside a wall, in the cavity, above the rim and outside; a
few control steps of the solid resting in the container match the JAX
``make_step_fn``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real2sim_eval_tpu.physics import sdf as jsdf
from real2sim_eval_tpu.physics import spring_mass as jsm
from real2sim_eval_tpu.physics import topology as jtopo
from real2sim_eval_tpu.utils import mesh as jmesh
from real2sim_eval_tpu_torch import testing as tt
from real2sim_eval_tpu_torch.experiments.utils.create_rigid_phystwin import \
    sample_rigid_points
from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
from real2sim_eval_tpu_torch.physics import fused_step
from real2sim_eval_tpu_torch.physics import sdf as tsdf
from real2sim_eval_tpu_torch.physics import spring_mass as tsm
from real2sim_eval_tpu_torch.renderer import RasterConfig
from real2sim_eval_tpu_torch.utils import mesh as tmesh
from real2sim_eval_tpu_torch.utils.ply import save_gaussian_ply
from torch_cli_scene import one_thread

EPISODES = [0, 1, 2, 3]          # object cell ep % 2, container cell ep // 2
OBJ_GRID = dict(xy=[[0.0, 0.0], [0.03, -0.02]], theta=[0, 10],
                one_to_one=True)
BOX_GRID = dict(xy=[[0.0, 0.0], [0.04, 0.03]], theta=[0, 20],
                one_to_one=True)
# the container: outer size (m) and wall
BOX_SIZE, WALL = (0.12, 0.10, 0.05), 0.005
BRANCHES = {"off": RasterConfig(incremental="off"),
            "on": RasterConfig(incremental="on", wrist_precull="on"),
            "fine": RasterConfig(incremental="on", wrist_precull="on",
                                 kernel="fine")}
RGB_TOL, DEPTH_TOL = 2e-3, 1e-3


def container(size=BOX_SIZE, wall=WALL, mesh_mod=tmesh):
    """An open box resting on z = 0: a floor and four walls, none
    overlapping another."""
    x, y, z, w = size[0] / 2, size[1] / 2, size[2], wall

    def box(x0, x1, y0, y1, z0, z1):
        return mesh_mod.make_box((x1 - x0, y1 - y0, z1 - z0),
                                 center=((x0 + x1) / 2, (y0 + y1) / 2,
                                         (z0 + z1) / 2))
    return mesh_mod.merge_meshes([
        box(-x, x, -y, y, 0.0, w), box(-x, -x + w, -y, y, w, z),
        box(x - w, x, -y, y, w, z), box(-x + w, x - w, -y, -y + w, w, z),
        box(-x + w, x - w, y - w, y, w, z)])


def solid_points():
    """A 6 x 3 x 3 cm block sampled as a rigid PhysTwin is."""
    s, i = sample_rigid_points(tmesh.make_box((0.06, 0.03, 0.03),
                                              center=(0.0, 0.0, 0.015)),
                               n_surface=1500, grid_size=0.008, seed=0)
    return np.concatenate([s, i]).astype(np.float32)


def write_scene(root, box_grid=BOX_GRID):
    """The tiny sloth-shaped scene and its config."""
    pts = solid_points()
    tt.write_fixture_checkpoint(root, "plush", pts, radius=0.02,
                                max_neighbours=12, spring_Y=500.0)
    gs = tt.make_synthetic_scene(root / "scans", rope_pts=pts,
                                 ik_urdf=tt.BUILTIN_URDF, n_table=1200)
    box = container()
    tmesh.save_obj(box, root / "box.obj")
    rng = np.random.default_rng(3)
    save_gaussian_ply(tt._splat_params(box.sample_surface(300, rng),
                                       np.tile([[0.7, 0.6, 0.4]], (300, 1))),
                      root / "box_splat.ply")
    gs["use_grid_randomization"] = True
    gs["object"] = dict(gs["object"], grid_randomization=OBJ_GRID,
                        pose=[1.0, 0.0, 0.0, 0.40, 0.0, 1.0, 0.0, -0.10,
                              0.0, 0.0, 1.0, 0.005, 0.0, 0.0, 0.0, 1.0])
    mesh = dict(name="box-1", splat_path=str(root / "box_splat.ply"),
                mesh_path=str(root / "box.obj"),
                pose=[1.0, 0.0, 0.0, 0.45, 0.0, 1.0, 0.0, 0.12,
                      0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0],
                translation_range=[0.0] * 6, azimuth_range=[0, 0])
    if box_grid is not None:
        mesh["grid_randomization"] = box_grid
    gs["meshes"] = [mesh]
    return tt.full_cfg(root, "plush", gs=gs, cameras=tt.TEST_CAMERAS,
                       physics_over=dict(dt=2e-4, self_collision=True,
                                         object_max_neighbours=12))


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """One torch thread: the suite runs files side by side in workers."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    return write_scene(tmp_path_factory.mktemp("mesh_groups"))


@pytest.fixture(scope="module")
def singles(cfg):
    """One-episode builds of episodes 0 and 3 (one in each container cell,
    each in its own object cell), on each branch, and their frames."""
    out = {}
    for branch, rc in BRANCHES.items():
        for ep in (EPISODES[0], EPISODES[3]):
            ev = BatchedEvaluator(cfg, [ep], raster_config=rc, device="cpu")
            out[branch, ep] = (ev, [f.numpy() for f in ev.render()])
    return out


@pytest.fixture(scope="module")
def jax_singles(cfg):
    """JAX ``BatchedEvaluator``s of episodes 0 and 3 alone (right at one
    episode: it keeps episode 0's meshes over every lane), rendered by the
    dense reference of each kernel family: their mesh splats and frames."""
    import copy

    from real2sim_eval_tpu.config import ConfigNode as JConfigNode
    from real2sim_eval_tpu.parallel import BatchedEvaluator as JEval
    from real2sim_eval_tpu.renderer import RasterConfig as JRC

    jcfg = JConfigNode(copy.deepcopy(cfg.to_dict()))
    out = {}
    for family in ("wide", "fine"):
        rc = JRC(backend="reference", kernel=family)
        for ep in (EPISODES[0], EPISODES[3]):
            jev = JEval(jcfg, episode_ids=[ep], raster_config=rc,
                        physics_backend="xla")
            box = jev.mesh_params["box-1"]
            out[family, ep] = ({k: np.asarray(v) for k, v in box.items()},
                               [np.asarray(f) for f in jev.render()[:4]])
    return out


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_lanes_carry_their_own_box(cfg, singles, jax_singles, branch):
    """Each lane's mesh splats are bitwise a one-episode build's of its
    container cell, the lanes fall into one group per container cell, and
    the frames (both cameras) of a lane in each group are within the
    compositor tolerances of its episode's build. That build is tied to
    the JAX package: its mesh splats bitwise, and its frames within the
    same tolerances, of a JAX evaluator of that episode alone."""
    ev = BatchedEvaluator(cfg, EPISODES, raster_config=BRANCHES[branch],
                          device="cpu")
    assert ev.n_mesh_groups == 2
    assert ev.lane_group.tolist() == [0, 0, 1, 1]
    assert ev.incremental == (branch != "off")
    if ev.incremental:
        assert ev.wrist_cull["static"]
        n_cams = len(ev._cam_static)
        assert ev._fixed_kw["groups"].rgb_cache.shape[0] == 2 * n_cams
    box = ev.assets.mesh_params["box-1"]
    frames = [f.numpy() for f in ev.render()]
    for i, ep in enumerate(EPISODES):
        one, _ = singles[branch, EPISODES[3 * (ep // 2)]]
        own = one.assets.mesh_params["box-1"]
        for k in box:
            assert torch.equal(box[k][i], own[k][0]), (ep, k)
    family = "fine" if branch == "fine" else "wide"
    for i in (0, 3):
        one, own_frames = singles[branch, EPISODES[i]]
        j_box, j_frames = jax_singles[family, EPISODES[i]]
        for k, v in one.assets.mesh_params["box-1"].items():
            np.testing.assert_array_equal(v[0].numpy(), j_box[k], err_msg=k)
        for rgb, depth in ((0, 1), (2, 3)):
            assert j_frames[rgb].max() > 0.05     # the frame shows the scene
            np.testing.assert_allclose(own_frames[rgb], j_frames[rgb],
                                       atol=RGB_TOL, rtol=0)
            np.testing.assert_allclose(own_frames[depth], j_frames[depth],
                                       atol=DEPTH_TOL, rtol=0)
        for rgb, depth in ((0, 1), (2, 3)):
            np.testing.assert_allclose(frames[rgb][i], own_frames[rgb][0],
                                       atol=RGB_TOL, rtol=0)
            np.testing.assert_allclose(frames[depth][i], own_frames[depth][0],
                                       atol=DEPTH_TOL, rtol=0)
    assert not torch.equal(box["means3D"][0], box["means3D"][2])


def test_one_pose_is_the_broadcast_layout(tmp_path):
    """With the container on one pose the lanes form one group, and the
    frames of the full pipeline and the incremental branch are bitwise
    those of the same assets with the mesh's splats shared (N_m, ...) by
    every lane."""
    cfg = write_scene(tmp_path, box_grid=None)
    for rc in (BRANCHES["off"], BRANCHES["on"]):
        ev = BatchedEvaluator(cfg, EPISODES, raster_config=rc, device="cpu")
        assert ev.n_mesh_groups == 1
        assert ev.lane_group.tolist() == [0, 0, 0, 0]
        a = ev.assets
        shared = dataclasses.replace(a, mesh_params={
            name: {k: v[0] for k, v in pm.items()}
            for name, pm in a.mesh_params.items()})
        bc = BatchedEvaluator(shared, EPISODES, raster_config=rc,
                              device="cpu")
        assert bc.n_mesh_groups == 1
        for got, want in zip(ev.render(), bc.render()):
            assert torch.equal(got, want)


# query points in the container's frame, (name, point, sign of the SDF)
PROBES = [("inside a wall", (BOX_SIZE[0] / 2 - WALL / 2, 0.0, 0.025), -1),
          ("in the cavity", (0.0, 0.0, 0.025), 1),
          ("above the rim", (BOX_SIZE[0] / 2 - WALL / 2, 0.0, 0.065), 1),
          ("outside", (BOX_SIZE[0] / 2 + 0.01, 0.0, 0.025), 1)]


def test_container_sdf_matches_jax():
    """The open container's SDF grid is bitwise the JAX package's, and the
    port's query matches JAX's ``sdf_query`` with the right sign inside a
    wall, in the cavity, above the rim and outside."""
    g_t = tsdf.build_sdf_grid(container())
    g_j = jsdf.build_sdf_grid(container(mesh_mod=jmesh))
    np.testing.assert_array_equal(g_t.values.numpy(), np.asarray(g_j.values))
    pts = np.array([p for _, p, _ in PROBES], np.float32)
    d_t, n_t = tsdf.sdf_query(g_t, torch.as_tensor(pts))
    d_j, n_j = jsdf.sdf_query(g_j, jnp.asarray(pts))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-6)
    for (name, _, sign), d in zip(PROBES, d_t.numpy()):
        assert np.sign(d) == sign, (name, d)


def test_solid_in_container_matches_jax():
    """Three control steps of 58 substeps of the solid falling onto the
    container's floor beside a wall, with self-collision: the port's
    plain step against the JAX package's ``make_step_fn``."""
    # beside a wall, just above the floor, within the contact distance
    rest = solid_points() + np.float32([0.02, 0.0, 0.0055])
    n = len(rest)
    springs, rl = jtopo.connect_springs(rest, radius=0.02, max_neighbours=12)
    y_log = np.full(len(springs), np.log(500.0), np.float32)
    nbr = jtopo.build_neighbor_tables(springs, rl, y_log, n)
    common = dict(
        masses=np.ones(n, np.float32), nbr_idx=nbr[0], nbr_rest=nbr[1],
        nbr_Y_log=nbr[2], collision_mask=np.arange(n, dtype=np.int32),
        rest_x=rest, springs=springs, rest_lengths=rl, spring_Y_log=y_log,
        collide_elas=np.float32(0.5), collide_fric=np.float32(0.3),
        collide_eef_elas=np.float32(0.0), collide_eef_fric=np.float32(1.0),
        collide_self_elas=np.float32(0.5), collide_self_fric=np.float32(0.3))
    # a solid has no banded (rolled) tables: the neighbour gather
    pj = jsm.SpringMassParams(**{k: jnp.asarray(v) for k, v in common.items()})
    pt = tsm.SpringMassParams(**{k: torch.as_tensor(v)
                                 for k, v in common.items()})
    kw = dict(num_substeps=58, self_collision=True, n_fingers=0,
              max_candidates=8, max_self_particles=128,
              max_contact_particles=256, max_self_slots=4)
    oj, ot = jsm.PhysicsOptions(**kw), tsm.PhysicsOptions(**kw)
    grid = jsdf.build_sdf_grid(container(mesh_mod=jmesh))
    port = tsdf.SdfGrid(*(torch.as_tensor(np.array(getattr(grid, f)))
                          for f in ("origin", "inv_spacing", "values",
                                    "corners")))
    B = 2
    pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1, 1))
    pose[1, 0, :3, 3] = [0.004, -0.003, 0.0]
    x0 = np.tile(rest[None], (B, 1, 1))
    one = dict(eef_xyz=np.float32([0.3, 0.0, 0.3]),
               eef_vel=np.zeros(3, np.float32),
               eef_rot=np.eye(3, dtype=np.float32),
               eef_rot_vel=np.zeros(3, np.float32),
               openness_start=np.float32(1.0), openness_end=np.float32(1.0),
               dyn_lin_vel=np.zeros((1, 3), np.float32),
               dyn_omega=np.zeros(3, np.float32))
    ctrl = {k: np.broadcast_to(np.asarray(v)[None], (B,) + np.shape(v))
            for k, v in one.items()}
    cj = jsm.SubstepControls(**{k: jnp.asarray(v) for k, v in ctrl.items()})
    ct = tsm.SubstepControls(**{k: torch.as_tensor(np.array(v))
                                for k, v in ctrl.items()})
    colj = jsm.MeshColliderSet(fingers=(), finger_pose_table=jnp.zeros(
        (1, 101, 4, 4)), statics=(grid,), static_pose=jnp.zeros((1, 4, 4)))
    colt = tsm.MeshColliderSet(fingers=(), finger_pose_table=torch.zeros(
        (1, 101, 4, 4)), statics=(port,), static_pose=torch.as_tensor(pose))
    step_j = jsm.make_step_fn(oj, has_colliders=True)

    def one_env(sp, sm, c):
        return step_j(pj, colj.replace(static_pose=sp), sm, c)

    ref = jax.jit(lambda sm, c: jax.vmap(one_env)(jnp.asarray(pose), sm, c))
    fused = fused_step.make_fused_step_fn(ot, has_colliders=True,
                                          device="cpu")
    sj = jsm.SpringMassState(x=jnp.asarray(x0), v=jnp.zeros((B, n, 3)),
                             finger_forces=jnp.zeros((B, 1, 3)))
    st = tsm.SpringMassState(x=torch.as_tensor(x0),
                             v=torch.zeros((B, n, 3)),
                             finger_forces=torch.zeros((B, 1, 3)))
    rest_b = torch.as_tensor(x0)
    for _ in range(3):
        sj = ref(sj, cj)
        st = fused(pt, colt, st, ct, rest_b)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), atol=3e-5)
    np.testing.assert_allclose(st.v.numpy(), np.asarray(sj.v), atol=1.5e-3)
    np.testing.assert_array_equal(st.telemetry.numpy()[:, :3],
                                  np.asarray(sj.telemetry)[:, :3])
    # the floor holds the solid: nothing passes into it
    assert st.x.numpy()[..., 2].min() > WALL - 1e-3
