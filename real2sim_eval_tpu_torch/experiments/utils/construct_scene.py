"""Scene-scan construction: align a Gaussian scan to the robot frame and
segment its robot Gaussians into per-link masks.

Counterpart of the JAX package's experiments/utils/construct_scene.py (the
reference's assets/scans/construct_scene_{gripper,pusher}.py):
  1. sample a URDF robot point cloud at the canonical base qpos
  2. coarse global registration + trimmed ICP aligns the scan to the robot
     frame (utils/icp.py: PCA init + trimmed ICP; ``--crop`` restricts the
     fit to the scan's points inside a box, which a whole tabletop scan
     needs: its principal axes are the table's)
  3. the scan's points inside the robot's padded bbox take the link id of
     their nearest sampled robot point, in SAPIEN document order: link1..
     link7 -> 2..8, then the gripper links -> 10.. (skipping 9 =
     link_eef); every other point gets -1
  4. save the re-posed scan PLY + mask npy (the renderer's total_mask_path)
  5. with ``--visualize``, re-pose the robot splats at ``--qpos`` and
     ``--gripper`` and render a preview PNG: the port's
     ``RobotArticulation`` and ``rasterize`` (K1) on ``--device``, the
     card unless ``--device cpu``.
Steps 1-4 are host numpy and scipy, with the JAX tool's arithmetic, so the
same scan gives the same PLY and mask bit for bit.

Usage:
  python -m real2sim_eval_tpu_torch.experiments.utils.construct_scene \\
      --scan raw.ply --out scene.ply --mask scene_mask.npy \\
      --urdf assets/robots/xarm/xarm7_with_gripper.urdf [--pusher]
      [--visualize out.png --qpos 10 -20 30 15 4 54 20 --gripper 100]
      [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ...kinematics.robot import RobotModel
from ...utils.device import resolve_device
from ...utils.gs_processor import GSProcessor
from ...utils.icp import global_registration, icp, registration_error

GRIPPER_LINKS = [
    "link1", "link2", "link3", "link4", "link5", "link6", "link7",
    "xarm_gripper_base_link",
    "left_outer_knuckle", "left_finger", "left_inner_knuckle",
    "right_outer_knuckle", "right_finger", "right_inner_knuckle",
]
PUSHER_LINKS = ["link1", "link2", "link3", "link4", "link5", "link6",
                "link7", "pusher_base_link"]
PTS_PER_LINK = 2000
BASE_GRIPPER_COUNTS = 750


def sample_robot_points(urdf_path, link_names, openness_counts=BASE_GRIPPER_COUNTS):
    robot = RobotModel(urdf_path, link_names=link_names)
    n_extra = robot.chain.n_dof - 7
    from ...kinematics.robot import CANONICAL_ARM_QPOS

    if n_extra > 0:
        ang = (800 - openness_counts) * 0.001
        qpos = np.concatenate([CANONICAL_ARM_QPOS, np.full(n_extra, ang)])
    else:
        qpos = CANONICAL_ARM_QPOS
    pts = robot.compute_robot_pcd(qpos, link_names=link_names,
                                  num_pts=PTS_PER_LINK)
    return pts, robot


def align_scan_to_robot(scan_pts, robot_pts, crop_bbox=None):
    """scan -> robot-frame 4x4 transform. ``crop_bbox`` (3, 2) optionally
    restricts the scan points used for fitting (when more than 100 fall
    inside it)."""
    src = np.asarray(scan_pts, np.float64)
    if crop_bbox is not None:
        bb = np.asarray(crop_bbox)
        m = np.ones(len(src), bool)
        for a in range(3):
            m &= (src[:, a] > bb[a, 0]) & (src[:, a] < bb[a, 1])
        if m.sum() > 100:
            src = src[m]
    T0 = global_registration(src, robot_pts)
    T = icp(src, robot_pts, init=T0, thresholds=(0.04, 0.01))
    err = registration_error(src, robot_pts, T)
    print(f"scan->robot alignment error: {err:.4f} m")
    return T


def segment_robot(params, robot_pts, link_names, use_pusher=False):
    """Per-Gaussian link-id mask. Returns (mask (N,), is_robot (N,)).
    Non-robot gaussians get -1 (stored as is; the articulation clamps it
    to 0, an identity row)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(params["means3D"], np.float64)
    rb = np.asarray(robot_pts)
    bbox = np.array([
        [rb[:, 0].min() - 0.10, rb[:, 0].max() + 0.10],
        [rb[:, 1].min() - 0.10, rb[:, 1].max() + 0.10],
        [rb[:, 2].min(), rb[:, 2].max() + 0.10],  # hard stop at z-min: the
        # base ring stays with the table splats
    ])
    is_robot = np.ones(len(pts), bool)
    for a in range(3):
        is_robot &= (pts[:, a] > bbox[a, 0]) & (pts[:, a] < bbox[a, 1])

    tree = cKDTree(rb)
    _, idx = tree.query(pts[is_robot], k=1, workers=-1)
    link_of_point = (idx // PTS_PER_LINK).astype(np.int32)

    # sampled-link index -> document-order link id:
    # arm links link1..7 -> ids 2..8; then skip 9 (link_eef): gripper links
    # -> 10.. ("+2", then ">= 9 += 1")
    ids = link_of_point + 2
    if not use_pusher:
        ids[ids >= 9] += 1
    else:
        ids[ids >= 9] += 1  # pusher_base_link -> 10

    mask = np.full(len(pts), -1, np.int32)
    mask[is_robot] = ids
    return mask, is_robot


def articulate_preview(params, mask, urdf_path, qpos_deg, gripper_counts,
                       out_png, use_pusher=False, device="cuda"):
    """Re-pose the segmented robot splats at ``qpos_deg`` (7 joints, in
    degrees) and the gripper's ``gripper_counts`` and write an 848x480
    preview image: the articulation and the render (K1) run on
    ``device``."""
    import cv2
    import torch

    from ...renderer.raster import RasterConfig, rasterize
    from ...renderer.camera import Camera, orbit_camera_w2c
    from ...renderer.scene import (RobotArticulation, XARM_GRIPPER_LINK_IDS,
                                   XARM_PUSHER_LINK_IDS)
    from ...kinematics.robot import CANONICAL_ARM_QPOS
    from ...utils.gs_processor import activate_params
    from ...utils.ply import sh_colors_to_coeffs

    dev = resolve_device(device)
    robot = RobotModel(urdf_path)
    link_ids = XARM_PUSHER_LINK_IDS if use_pusher else XARM_GRIPPER_LINK_IDS
    link_ids = tuple(i for i in link_ids if i < len(robot.chain.link_names))
    n_extra = robot.chain.n_dof - 7
    base_q = np.concatenate([CANONICAL_ARM_QPOS,
                             np.full(n_extra, (800 - BASE_GRIPPER_COUNTS) * 0.001)]
                            ) if n_extra else CANONICAL_ARM_QPOS
    art = RobotArticulation.build(robot, link_ids, base_q, use_pusher,
                                  device=dev)

    act = activate_params(dict(params,
                               sh_colors=sh_colors_to_coeffs(params["sh_colors"])
                               if np.asarray(params["sh_colors"]).ndim == 2
                               else params["sh_colors"]))
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    q7 = np.asarray(qpos_deg, np.float64) * np.pi / 180
    qf = art.full_qpos(t(q7.astype(np.float32))[None],
                       torch.tensor([float(gripper_counts)],
                                    dtype=torch.float32, device=dev))
    means, quats = art.apply(qf, t(act["means3D"]), t(act["rotations"]),
                             t(np.maximum(mask, 0)))

    w2c = orbit_camera_w2c((0.3, 0.0, 0.3), 1.2, 25, 160)
    cam = Camera(width=848, height=480, fx=424.0, fy=424.0, cx=424.0, cy=240.0)
    im, _ = rasterize(cam, w2c, means[0], t(act["scales"]), quats[0],
                      t(act["opacities"]), t(act["shs"][:, :1]), 0,
                      config=RasterConfig(), device=dev)
    img = (np.clip(im.cpu().numpy(), 0, 1).transpose(1, 2, 0) * 255
           ).astype(np.uint8)
    cv2.imwrite(str(out_png), img[:, :, ::-1])
    print(f"wrote preview {out_png}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scan", required=True, help="raw scene scan PLY")
    parser.add_argument("--out", required=True, help="re-posed scan PLY out")
    parser.add_argument("--mask", required=True, help="link mask npy out")
    parser.add_argument("--urdf", required=True)
    parser.add_argument("--pusher", action="store_true")
    parser.add_argument("--crop", type=float, nargs=6, default=None,
                        metavar=("X0", "X1", "Y0", "Y1", "Z0", "Z1"),
                        help="bbox for the alignment crop")
    parser.add_argument("--visualize", default=None,
                        help="write an articulation preview png")
    parser.add_argument("--qpos", type=float, nargs=7,
                        default=[10, -20, 30, 15, 4, 54, 20])
    parser.add_argument("--gripper", type=float, default=100)
    parser.add_argument("--device", default="cuda",
                        help="the preview's device: cuda (the kernels) or "
                             "cpu (their plain versions)")
    args = parser.parse_args(argv)
    if args.visualize:          # refuse before writing anything
        resolve_device(args.device)

    sp = GSProcessor()
    params = sp.load(args.scan)
    link_names = PUSHER_LINKS if args.pusher else GRIPPER_LINKS
    robot_pts, _ = sample_robot_points(args.urdf, link_names)

    crop = (np.asarray(args.crop).reshape(3, 2) if args.crop else None)
    T = align_scan_to_robot(params["means3D"], robot_pts, crop)
    params = sp.rotate(params, T[:3, :3])
    params = sp.translate(params, T[:3, 3])

    mask, is_robot = segment_robot(params, robot_pts, link_names, args.pusher)
    print(f"robot gaussians: {int(is_robot.sum())} / {len(mask)}")

    np.save(args.mask, mask)
    sp.save(params, args.out)
    print(f"wrote {args.out} and {args.mask}")

    if args.visualize:
        articulate_preview(params, mask, args.urdf, args.qpos, args.gripper,
                           args.visualize, args.pusher, device=args.device)


if __name__ == "__main__":
    main()
