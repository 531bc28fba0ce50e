"""The port's host asset code against the JAX package's, on the CPU.

Mesh loaders (OBJ, binary and ascii STL, ascii and binary PLY) and a URDF
that names a scaled mesh file; ``RobotModel`` on the built-in arm, bitwise;
PhysTwin checkpoints written by either package and read by the other;
``GSProcessor`` and ``activate_params``; the scene helpers and the non-LBS
blend; the new transforms; the fixture writers (same PLY bytes, mask and
checkpoint contents for the same seed); and ``make_flagship_assets``'
finger tables, now from ``RobotModel``, against the hand-built ones they
replace."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real2sim_eval_tpu import testing as jtesting
from real2sim_eval_tpu.kinematics.robot import RobotModel as JRobot
from real2sim_eval_tpu.physics import checkpoints as jck
from real2sim_eval_tpu.renderer import lbs as jlbs
from real2sim_eval_tpu.renderer import scene as jscene
from real2sim_eval_tpu.utils import gs_processor as jgs
from real2sim_eval_tpu.utils import mesh as jmesh
from real2sim_eval_tpu.utils import transforms as jtf
from real2sim_eval_tpu.utils import urdf as jurdf
from real2sim_eval_tpu_torch import testing as ttesting
from real2sim_eval_tpu_torch.kinematics.robot import RobotModel as TRobot
from real2sim_eval_tpu_torch.physics import checkpoints as tck
from real2sim_eval_tpu_torch.renderer import lbs as tlbs
from real2sim_eval_tpu_torch.renderer import scene as tscene
from real2sim_eval_tpu_torch.utils import gs_processor as tgs
from real2sim_eval_tpu_torch.utils import mesh as tmesh
from real2sim_eval_tpu_torch.utils import transforms as ttf
from real2sim_eval_tpu_torch.utils import urdf as turdf

FINGERS = ["left_finger", "right_finger"]


def assert_mesh_equal(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert a.vertices.dtype == b.vertices.dtype
    assert a.faces.dtype == b.faces.dtype


# ---------------------------------------------------------------------------
# meshes and URDF files
# ---------------------------------------------------------------------------


def _write_stl_binary(path, tri):
    with open(path, "wb") as f:
        f.write(b"binary stl".ljust(80, b" "))
        f.write(struct.pack("<I", len(tri)))
        for t in tri:
            f.write(struct.pack("<3f", 0.0, 0.0, 1.0))
            f.write(np.asarray(t, "<f4").tobytes())
            f.write(struct.pack("<H", 0))


def _write_stl_ascii(path, tri):
    lines = ["solid box"]
    for t in tri:
        lines += ["facet normal 0 0 1", "outer loop"]
        lines += [f"vertex {float(x)!r} {float(y)!r} {float(z)!r}"
                  for x, y, z in t]
        lines += ["endloop", "endfacet"]
    lines.append("endsolid box")
    open(path, "w").write("\n".join(lines) + "\n")


def _write_ply_mesh(path, v, f, binary):
    head = ["ply", "format " + ("binary_little_endian" if binary else "ascii")
            + " 1.0", f"element vertex {len(v)}", "property float x",
            "property float y", "property float z", f"element face {len(f)}",
            "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as fh:
        fh.write(("\n".join(head) + "\n").encode())
        if binary:
            fh.write(np.asarray(v, "<f4").tobytes())
            for face in f:
                fh.write(struct.pack("<B", len(face)))
                fh.write(np.asarray(face, "<i4").tobytes())
        else:
            for p in v:
                fh.write(" ".join(repr(float(c)) for c in p).encode() + b"\n")
            for face in f:
                fh.write((" ".join(map(str, [len(face), *face])) + "\n")
                         .encode())


def test_mesh_loaders_match(tmp_path):
    box = tmesh.make_box((0.03, 0.02, 0.05), center=(0.01, 0.0, 0.02))
    tri = box.vertices[box.faces]
    tmesh.save_obj(box, tmp_path / "box.obj")
    jmesh.save_obj(jmesh.TriMesh(box.vertices, box.faces), tmp_path / "j.obj")
    assert ((tmp_path / "box.obj").read_bytes()
            == (tmp_path / "j.obj").read_bytes())
    # a quad face and a negative index: fan triangulation in both
    (tmp_path / "quad.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2/2 3/3 -1\n")
    _write_stl_binary(tmp_path / "box.stl", tri)
    _write_stl_ascii(tmp_path / "box_ascii.stl", tri)
    quad = [[0, 1, 2, 3], [4, 5, 6], [0, 4, 7, 3]]
    _write_ply_mesh(tmp_path / "a.ply", box.vertices, quad, binary=False)
    _write_ply_mesh(tmp_path / "b.ply", box.vertices, quad, binary=True)
    for name in ("box.obj", "quad.obj", "box.stl", "box_ascii.stl", "a.ply",
                 "b.ply"):
        t = tmesh.load_mesh(tmp_path / name)
        assert_mesh_equal(t, jmesh.load_mesh(tmp_path / name))
    assert len(tmesh.load_mesh(tmp_path / "quad.obj").faces) == 2
    stl = tmesh.load_stl(tmp_path / "box.stl")
    assert len(stl.vertices) == 8 and len(stl.faces) == 12
    assert_mesh_equal(stl, tmesh.load_stl(tmp_path / "box_ascii.stl"))
    with pytest.raises(ValueError):
        tmesh.load_mesh(tmp_path / "box.xyz")


def test_mesh_ops_match():
    a = tmesh.make_box((0.1, 0.2, 0.3))
    b = tmesh.make_sphere(0.05, center=(0.1, 0, 0), n_lat=4, n_lon=6)
    ja, jb = (jmesh.TriMesh(m.vertices, m.faces) for m in (a, b))
    assert_mesh_equal(tmesh.merge_meshes([a, b]), jmesh.merge_meshes([ja, jb]))
    T = np.eye(4)
    T[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    T[:3, 3] = [0.1, 0.2, 0.3]
    assert_mesh_equal(a.copy().transform(T).scale(1.5, center=(0.1, 0, 0))
                      .translated([0.0, 0.0, -0.2]),
                      ja.copy().transform(T).scale(1.5, center=(0.1, 0, 0))
                      .translated([0.0, 0.0, -0.2]))
    assert a.triangles is a.faces


def _mesh_urdf(tmp_path):
    """A two-link arm whose second link collides through a scaled STL."""
    (tmp_path / "meshes").mkdir()
    finger = tmesh.make_box((0.01, 0.02, 0.04), center=(0.0, 0.0, 0.02))
    _write_stl_binary(tmp_path / "meshes" / "finger.stl",
                      finger.vertices[finger.faces])
    (tmp_path / "arm.urdf").write_text("""<?xml version="1.0"?>
<robot name="mesh_arm">
  <link name="base"><collision><geometry><box size="0.1 0.1 0.1"/></geometry>
    <origin xyz="0 0 0.05" rpy="0 0 0"/></collision></link>
  <link name="link7"/>
  <link name="left_finger"><collision>
    <geometry><mesh filename="package://meshes/finger.stl" scale="2 2 2"/>
    </geometry><origin xyz="0.01 0 0.02" rpy="0 0.1 0"/></collision>
    <visual><geometry><mesh filename="meshes/finger.stl"/></geometry>
    </visual></link>
  <joint name="j1" type="revolute"><parent link="base"/><child link="link7"/>
    <origin xyz="0 0 0.2" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3"/></joint>
  <joint name="j2" type="prismatic"><parent link="link7"/>
    <child link="left_finger"/><origin xyz="0 0.02 0.05" rpy="0 0 0"/>
    <axis xyz="0 1 0"/><limit lower="0" upper="0.04"/>
    <mimic joint="j1" multiplier="2" offset="0.1"/></joint>
</robot>
""")
    return tmp_path / "arm.urdf"


def test_urdf_mesh_file_with_scale(tmp_path):
    path = _mesh_urdf(tmp_path)
    tu, ju = turdf.load_urdf(path), jurdf.load_urdf(path)
    assert tu.link_names == ju.link_names
    assert tu.root_dir == ju.root_dir
    for tl, jl in zip(tu.links, ju.links):
        for kind in ("collision_meshes", "visual_meshes"):
            tk, jk = getattr(tl, kind), getattr(jl, kind)
            assert [(s, sc) for s, sc, _ in tk] == [(s, sc) for s, sc, _ in jk]
            for (_, _, to), (_, _, jo) in zip(tk, jk):
                np.testing.assert_array_equal(to, jo)
    for tj, jj in zip(tu.joints, ju.joints):
        assert (tj.mimic_joint, tj.mimic_multiplier, tj.mimic_offset) == (
            jj.mimic_joint, jj.mimic_multiplier, jj.mimic_offset)
    tm, to = tu.load_collision_mesh("left_finger")
    jm, jo = ju.load_collision_mesh("left_finger")
    assert_mesh_equal(tm, jm)
    np.testing.assert_array_equal(to, jo)
    assert tm.vertices[:, 2].max() == pytest.approx(0.08)   # scaled x2
    np.testing.assert_array_equal(tu.collision_offset("link7"), np.eye(4))
    # the RobotModel on it: meshes, offsets (link7 inherits the base's
    # collision origin) and the finger table, bitwise
    tr, jr = TRobot(path), JRobot(path)
    assert list(tr.meshes) == list(jr.meshes) == ["base", "left_finger"]
    for n in tr.meshes:
        assert_mesh_equal(tr.meshes[n], jr.meshes[n])
    for n in jr.offsets:
        np.testing.assert_array_equal(tr.offsets[n], jr.offsets[n])
    np.testing.assert_array_equal(tr.offsets["link7"], tr.offsets["base"])
    q = np.array([0.3, 0.01])
    np.testing.assert_array_equal(tr.fk_numpy(q), jr.fk_numpy(q))


# ---------------------------------------------------------------------------
# RobotModel on the built-in arm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("link_names", [None, FINGERS])
def test_robot_model_bitwise(link_names):
    tr = TRobot(ttesting.BUILTIN_URDF, link_names=link_names)
    jr = JRobot(jtesting.BUILTIN_URDF, link_names=link_names)
    assert list(tr.meshes) == list(jr.meshes)
    assert list(tr.offsets) == list(jr.offsets)
    for n in jr.meshes:
        assert_mesh_equal(tr.meshes[n], jr.meshes[n])
    for n in jr.offsets:
        np.testing.assert_array_equal(tr.offsets[n], jr.offsets[n])
    assert tr.finger_link_names() == jr.finger_link_names()
    assert tr.eef_link_name() == jr.eef_link_name()
    rng = np.random.default_rng(0)
    arm = jtesting_q0() + rng.uniform(-0.3, 0.3, 7)
    for o in (None, 0.0, 0.37, 1.0):
        np.testing.assert_array_equal(tr.full_qpos(arm, o),
                                      jr.full_qpos(arm, o))
    q = tr.full_qpos(arm, 0.4)
    np.testing.assert_array_equal(tr.fk_numpy(q), jr.fk_numpy(q))
    np.testing.assert_array_equal(tr.link_pose(q, "link7"),
                                  jr.link_pose(q, "link7"))
    np.testing.assert_array_equal(tr.compute_mesh_poses(q),
                                  jr.compute_mesh_poses(q))
    names = tr.finger_link_names()[-2:]
    np.testing.assert_array_equal(tr.finger_pose_table(names),
                                  jr.finger_pose_table(names))
    np.testing.assert_array_equal(tr.eef_points_table(n_samples=11),
                                  jr.eef_points_table(n_samples=11))
    for o in (0.0, 0.5, 1.0):
        assert tscene_angle(o) == jrobot_angle(o)


def jtesting_q0():
    from real2sim_eval_tpu.kinematics.robot import CANONICAL_ARM_QPOS
    return CANONICAL_ARM_QPOS


def tscene_angle(o):
    from real2sim_eval_tpu_torch.kinematics.robot import \
        openness_to_finger_angle
    return float(openness_to_finger_angle(o))


def jrobot_angle(o):
    from real2sim_eval_tpu.kinematics.robot import openness_to_finger_angle
    return float(openness_to_finger_angle(o))


def test_articulation_build_from_robot_model():
    tr, jr = TRobot(ttesting.BUILTIN_URDF), JRobot(jtesting.BUILTIN_URDF)
    ids = tuple(i for i in tscene.XARM_GRIPPER_LINK_IDS
                if i < len(tr.chain.link_names))
    assert tscene.XARM_GRIPPER_LINK_IDS == jscene.XARM_GRIPPER_LINK_IDS
    assert tscene.XARM_PUSHER_LINK_IDS == jscene.XARM_PUSHER_LINK_IDS
    assert ttesting.GRIPPER_LINK_IDS is tscene.XARM_GRIPPER_LINK_IDS
    base_q = tr.full_qpos(jtesting_q0(), 0.9)
    ta = tscene.RobotArticulation.build(tr, ids, base_q, use_pusher=True)
    ja = jscene.RobotArticulation.build(jr, ids, base_q, use_pusher=True)
    for k in ("base_inv", "offsets", "active"):
        np.testing.assert_array_equal(getattr(ta, k).numpy(),
                                      np.asarray(getattr(ja, k)))
    assert ta.link_ids == ja.link_ids and ta.use_pusher


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _ckpt_args(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.1, 0.1, (40, 3)).astype(np.float32)
    return dict(object_points=pts, surface_points=pts[:5] + 0.01,
                interior_points=pts[5:8] - 0.01,
                spring_Y=rng.uniform(1e3, 5e3, 60).astype(np.float32),
                num_object_springs=60, collide_elas=0.4, collide_fric=0.2,
                optimal_params={"collide_object_elas": 0.7, "dt": 1e-4},
                object_colors=rng.uniform(size=(1, 40, 3)).astype(np.float32))


def _read_all(mod, root, case):
    return (mod.load_final_data(root / "data", case),
            mod.load_optimal_params(root / "experiments_optimization", case),
            mod.load_first_order(root / "experiments", case))


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), k)


@pytest.mark.parametrize("use_torch", [True, False], ids=["pth", "npz"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_read(tmp_path, writer, use_torch):
    mod = jck if writer == "jax" else tck
    mod.write_phystwin_checkpoint(tmp_path, "case", use_torch=use_torch,
                                  **_ckpt_args())
    for a, b in zip(_read_all(tck, tmp_path, "case"),
                    _read_all(jck, tmp_path, "case")):
        _assert_tree_equal(a, b)
    opt = tck.load_optimal_params(tmp_path / "experiments_optimization",
                                  "case")
    assert "init_spring_Y" in opt and "collide_self_elas" in opt


def test_apply_optimal_params_alike():
    from real2sim_eval_tpu_torch.config import ConfigNode
    base = dict(init_spring_Y=1.0, collide_self_elas=0.5, num_substeps=3,
                self_collision=False)
    opt = {"init_spring_Y": np.float32(2.5), "collide_self_elas": 1,
           "num_substeps": 7.0, "self_collision": 1}
    t, j = ConfigNode(base), ConfigNode(base)
    tck.apply_optimal_params(t, opt)
    jck.apply_optimal_params(j, opt)
    assert t.to_dict() == j.to_dict()
    assert type(t.num_substeps) is int and t.self_collision is True
    with pytest.raises(KeyError):
        tck.apply_optimal_params(t, {"missing": 1})


# ---------------------------------------------------------------------------
# splat processing, scene helpers, non-LBS blend, transforms
# ---------------------------------------------------------------------------


def _raw_splats(n, n_rest=45, seed=0):
    rng = np.random.default_rng(seed)
    return {"means3D": rng.normal(size=(n, 3)).astype(np.float32),
            "sh_colors": rng.normal(size=(n, 3 + n_rest)).astype(np.float32),
            "log_scales": rng.normal(-5, 0.5, (n, 3)).astype(np.float32),
            "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
            "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32)}


def test_gs_processor_matches(tmp_path):
    tp, jp = tgs.GSProcessor(), jgs.GSProcessor()
    raw = _raw_splats(50)
    tp.save(raw, tmp_path / "a.ply")
    jp.save(raw, tmp_path / "b.ply")
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    R = jtf.euler_to_rot(jnp.asarray([0.1, -0.2, 0.3]))
    R = np.asarray(R, np.float32)
    for rot in (False, True):
        _assert_tree_equal(tp.load(tmp_path / "a.ply", rot_x_minus90=rot),
                           jp.load(tmp_path / "a.ply", rot_x_minus90=rot))
    _assert_tree_equal(tp.load_phystwin(tmp_path / "a.ply"),
                       jp.load_phystwin(tmp_path / "a.ply"))
    other = _raw_splats(7, seed=1)
    bbox = [[-0.5, 0.5], [-1, 1], [-2, 0.3]]
    for name, args in (("rotate", (raw, R)), ("translate", (raw, [1, 2, 3])),
                       ("scale", (raw, 1.7)), ("crop", (raw, bbox)),
                       ("apply_mask", (raw, raw["means3D"][:, 0] > 0)),
                       ("merge", ([raw, other],))):
        _assert_tree_equal(getattr(tp, name)(*args), getattr(jp, name)(*args))
    _assert_tree_equal(tp.crop(raw, bbox, invert=True),
                       jp.crop(raw, bbox, invert=True))
    _assert_tree_equal(tgs.activate_params(raw), jgs.activate_params(raw))


def test_scene_helpers_match():
    rng = np.random.default_rng(2)
    shs = rng.normal(size=(30, 16, 3)).astype(np.float32)
    for A in (rng.normal(size=(3, 3)), rng.normal(size=(3, 6))):
        b = rng.normal(size=3)
        np.testing.assert_array_equal(tscene.correct_sh_colors(shs, A, b),
                                      jscene.correct_sh_colors(shs, A, b))
    with pytest.raises(ValueError):
        tscene.correct_sh_colors(shs, np.eye(4), np.zeros(3))
    tr, az = [-0.05, 0.05, -0.04, 0.04, 0.0, 0.01], [-10, 10]
    draws = tscene.uniform_random_values(np.random.RandomState(5), tr, az)
    assert draws == jscene.uniform_random_values(np.random.RandomState(5),
                                                 tr, az)
    pose = np.eye(4)
    pose[:3, 3] = [0.15, 0.0, 0.02]
    np.testing.assert_array_equal(tscene.apply_random_pose(pose, draws),
                                  jscene.apply_random_pose(pose, draws))
    params = tgs.activate_params(_raw_splats(40, seed=3))
    moved = tscene.apply_random_pose(pose, draws)
    _assert_tree_equal(tscene.transform_params_by_pose(params, moved),
                       jscene.transform_params_by_pose(params, moved))
    for cell in range(9):
        assert (tscene.grid_random_values(cell, [[0, 1], [2, 3], [4, 5]],
                                          [-10, 0, 10], False)
                == jscene.grid_random_values(cell, [[0, 1], [2, 3], [4, 5]],
                                             [-10, 0, 10], False))


def test_simple_weights_and_apply_match():
    # a rope of bones with points about it, as tests/test_torch_kinematics.py
    # holds knn_weights (random clouds put near-ties at the 16th neighbour,
    # which the two packages' distance roundings may order either way)
    rng = np.random.default_rng(4)
    t = np.linspace(0, 0.3, 60)
    bones = np.stack([t, 0.01 * np.sin(20 * t), np.zeros(60)], -1)
    bones = (bones + rng.normal(scale=1e-3, size=bones.shape)).astype(
        np.float32)
    pts = (bones[rng.integers(0, 60, 300)]
           + rng.normal(scale=0.01, size=(300, 3))).astype(np.float32)
    pred = (bones + rng.normal(scale=0.01, size=bones.shape)).astype(np.float32)
    w_t, i_t = tlbs.simple_weights(torch.as_tensor(bones),
                                   torch.as_tensor(pts), chunk=128)
    w_j, i_j = jlbs.simple_weights(jnp.asarray(bones), jnp.asarray(pts),
                                   chunk=128)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)
    xyz_t = tlbs.simple_apply(w_t, i_t, torch.as_tensor(pred))
    xyz_j = jlbs.simple_apply(w_j, i_j, jnp.asarray(pred))
    np.testing.assert_allclose(xyz_t.numpy(), np.asarray(xyz_j), atol=1e-6)
    # a leading env dim blends each env alone
    both = tlbs.simple_apply(w_t, i_t, torch.stack([torch.as_tensor(pred)] * 2))
    np.testing.assert_array_equal(both[1].numpy(), xyz_t.numpy())


def test_new_transforms_match():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(20, 4)).astype(np.float32)
    v = rng.normal(size=(20, 3)).astype(np.float32)
    aa = rng.normal(size=(20, 3)).astype(np.float32)
    aa[0] = 0.0
    rpy = rng.uniform(-1.5, 1.5, (20, 3)).astype(np.float32)
    pts = rng.normal(size=(2, 30, 3)).astype(np.float32)
    t = torch.as_tensor

    def close(a, b, tol=1e-6):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)

    close(ttf.quat_conjugate(t(q)), jtf.quat_conjugate(jnp.asarray(q)), 0)
    close(ttf.quat_rotate(t(q), t(v)), jtf.quat_rotate(jnp.asarray(q),
                                                       jnp.asarray(v)))
    close(ttf.axis_angle_to_quat(t(aa)), jtf.axis_angle_to_quat(
        jnp.asarray(aa)))
    R = ttf.euler_to_rot(t(rpy))
    close(R, jtf.euler_to_rot(jnp.asarray(rpy)))
    close(ttf.rot_to_euler(R), jtf.rot_to_euler(jnp.asarray(R.numpy())), 1e-5)
    close(ttf.rot_to_euler(R), rpy, 1e-5)
    Ts = ttf.xyzrpy_to_se3(t(v[:2]), t(rpy[:2]))
    close(Ts, jtf.xyzrpy_to_se3(v[:2], rpy[:2]))
    close(ttf.transform_points(Ts, t(pts)),
          jtf.transform_points(jnp.asarray(Ts.numpy()), jnp.asarray(pts)))


# ---------------------------------------------------------------------------
# fixture writers and the flagship's finger tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ik_urdf", [None, "builtin"])
def test_fixture_writers_match(tmp_path, ik_urdf):
    rope = ttesting.make_rope_points(n=50, length=0.2, seed=3)
    np.testing.assert_array_equal(
        rope, jtesting.make_rope_points(n=50, length=0.2, seed=3))
    springs_t = ttesting.write_fixture_checkpoint(tmp_path / "t", "c", rope,
                                                  spring_Y=2e3)
    springs_j = jtesting.write_fixture_checkpoint(tmp_path / "j", "c", rope,
                                                  spring_Y=2e3)
    np.testing.assert_array_equal(springs_t, springs_j)
    for a, b in zip(_read_all(tck, tmp_path / "t", "c"),
                    _read_all(tck, tmp_path / "j", "c")):
        _assert_tree_equal(a, b)
    urdf = {None: (None, None),
            "builtin": (ttesting.BUILTIN_URDF, jtesting.BUILTIN_URDF)}[ik_urdf]
    gs_t = ttesting.make_synthetic_scene(tmp_path / "t" / "scans",
                                         rope_pts=rope, ik_urdf=urdf[0],
                                         seed=1, n_table=200, n_obj_dense=40)
    gs_j = jtesting.make_synthetic_scene(tmp_path / "j" / "scans",
                                         rope_pts=rope, ik_urdf=urdf[1],
                                         seed=1, n_table=200, n_obj_dense=40)
    for name in ("object.ply", "scene.ply", "scene_mask.npy", "clip.obj",
                 "clip_splat.ply"):
        assert ((tmp_path / "t" / "scans" / name).read_bytes()
                == (tmp_path / "j" / "scans" / name).read_bytes()), name

    def strip(d):
        return {k: (strip(v) if isinstance(v, dict) else
                    [strip(x) if isinstance(x, dict) else x for x in v]
                    if isinstance(v, list) else v)
                for k, v in d.items() if not k.endswith("_path")
                and k not in ("path",)}
    assert strip(gs_t) == strip(gs_j)
    cfg_t = ttesting.full_cfg(tmp_path, "c", gs=gs_t,
                              cameras=ttesting.TEST_CAMERAS,
                              physics_over=dict(dt=2e-4))
    cfg_j = jtesting.full_cfg(tmp_path, "c", gs=gs_j,
                              cameras=jtesting.TEST_CAMERAS,
                              physics_over=dict(dt=2e-4))
    dt, dj = cfg_t.to_dict(), cfg_j.to_dict()
    dt.pop("gs"), dj.pop("gs")
    for d in (dt, dj):   # each package names its own built-in arm
        d["env"].pop("urdf")
    assert dt == dj
    assert ttesting.env_cfg(use_pusher=True).robot.use_pusher is True


def _hand_built_finger_tables():
    """make_flagship_assets' finger tables as they were built by hand
    before they came from RobotModel."""
    urdf = turdf.load_urdf(ttesting.BUILTIN_URDF)
    chain = TRobot(ttesting.BUILTIN_URDF).chain
    offsets, meshes, prev = {}, {}, np.eye(4)
    for link in urdf.links:
        if link.collision_meshes:
            spec, _, prev = link.collision_meshes[0]
            if link.name in FINGERS:
                meshes[link.name] = turdf.resolve_geometry(spec)
        offsets[link.name] = prev.copy()
    eef = chain.link_index("link_eef")
    table = np.zeros((2, 101, 4, 4))
    for s in range(101):
        ang = 0.8 * (1.0 - s / 100.0)
        q = np.concatenate([ttesting.CANONICAL_ARM_QPOS,
                            np.full(chain.n_dof - 7, ang)])
        fk = chain.fk_numpy(q)
        T_ew = np.linalg.inv(fk[eef])
        for f, name in enumerate(FINGERS):
            table[f, s] = T_ew @ fk[chain.link_index(name)] @ offsets[name]
    centroids = np.stack([meshes[n].vertices.mean(0) for n in FINGERS])
    return meshes, table, centroids, offsets


def test_flagship_finger_tables_from_robot_model():
    meshes, table, centroids, arm = ttesting._finger_tables()
    h_meshes, h_table, h_centroids, h_offsets = _hand_built_finger_tables()
    np.testing.assert_array_equal(table, h_table)
    np.testing.assert_array_equal(centroids, h_centroids)
    for n in FINGERS:
        assert_mesh_equal(meshes[n], h_meshes[n])
    for n in h_offsets:
        np.testing.assert_array_equal(arm.offsets[n], h_offsets[n])
    a = ttesting.make_flagship_assets(batch=2, n_table=200, n_obj_dense=0,
                                      device="cpu", n_rope=60)
    np.testing.assert_array_equal(a.colliders.finger_pose_table.numpy(),
                                  h_table.astype(np.float32))
    np.testing.assert_array_equal(a.finger_centroids.numpy(),
                                  h_centroids.astype(np.float32))


def _hand_built_object_poses(obj, batch):
    """make_flagship_assets' per-env object poses and env-0 object splats
    as they were built by hand before they came from the scene helpers."""
    xy, theta = ttesting.GRID_XY, ttesting.GRID_THETA
    pose0 = np.eye(4)
    pose0[:3, 3] = [0.15, 0.0, 0.02]
    poses = []
    for i in range(batch):
        cell = i % (len(xy) * len(theta))
        rx, ry = xy[cell // len(theta)]
        ang = theta[cell % len(theta)] * np.pi / 180.0
        pose = np.array(pose0, np.float64)
        pose[:3, 3] += [rx, ry, 0.0]
        c, s = np.cos(ang), np.sin(ang)
        pose[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) \
            @ pose[:3, :3]
        poses.append(pose)
    R = poses[0][:3, :3].astype(np.float32)
    w = np.sqrt(np.maximum(1 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2
    w1, x1, y1, z1 = np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                               (R[0, 2] - R[2, 0]) / (4 * w),
                               (R[1, 0] - R[0, 1]) / (4 * w)]
                              ).astype(np.float32)
    q = obj["rotations"]
    w2, x2, y2, z2 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    rotations = np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                          w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                          w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                          w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2],
                         -1).astype(np.float32)
    means = obj["means3D"] @ R.T + poses[0][:3, 3].astype(np.float32)
    inv0 = np.linalg.inv(poses[0])
    rel_pose = np.stack([(p @ inv0).astype(np.float32) for p in poses])
    return means, rotations, rel_pose


def test_flagship_object_poses_match_hand_built():
    """The flagship's grid-randomized object poses and env-0 splats, now
    from apply_random_pose / transform_params_by_pose, are bitwise those
    of the hand-built path, over all nine grid cells."""
    batch, n_rope, n_dense = 9, 60, 40
    a = ttesting.make_flagship_assets(batch=batch, n_table=200,
                                      n_obj_dense=n_dense, device="cpu",
                                      n_rope=n_rope)
    # the canonical object splats, regenerated as make_flagship_assets
    # draws them (rope, then the dense body from the same generator)
    rng = np.random.default_rng(0)
    pts = ttesting.make_rope_points(n=n_rope, length=0.4, seed=0).astype(
        np.float32).astype(np.float64)
    seg = rng.integers(0, n_rope - 1, n_dense)
    tt = rng.uniform(0.0, 1.0, (n_dense, 1))
    core = pts[seg] * (1.0 - tt) + pts[seg + 1] * tt
    pts = np.concatenate([pts, core + rng.normal(scale=0.008,
                                                 size=core.shape)])
    obj = ttesting._splats(pts, np.zeros((len(pts), 3)), 0.004)
    means, rotations, rel_pose = _hand_built_object_poses(obj, batch)
    np.testing.assert_array_equal(a.obj["means3D"].numpy(), means)
    np.testing.assert_array_equal(a.obj["rotations"].numpy(), rotations)
    np.testing.assert_array_equal(a.state.rel_pose.numpy(), rel_pose)
    assert len({p.tobytes() for p in rel_pose}) == 9
