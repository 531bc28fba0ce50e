"""The evaluator's assets, built from a config as the JAX package builds
them.

Counterpart of the JAX ``BatchedEvaluator.__init__`` reset loop and
``_snapshot_scene``: one ``BaseEnv`` (``envs.make(cfg.env_name, ...)``) is
reset once per episode with ``skip_obs``; the shared arrays (springs and
neighbour tables, SDF grids, object and scan splats, LBS bones, the
articulation tables, cameras, the kinematic chain) come from episode 0,
the per-env ones (object pose relative to episode 0, static mesh poses,
the attached meshes' splats at those poses, rest positions, gripper rows,
randomization draws) from every episode. The result is the
flat numpy tree of ``convert.assets_from_numpy``, so a config build and
the tests' bridge from a JAX evaluator meet in one format.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..convert import assets_from_numpy
from ..renderer.raster import RasterConfig
from ..utils.device import to_numpy
from ..utils.profiling import host_span


def _snapshot_scene(tree: dict, rend, cfg) -> None:
    """Shared scene arrays from episode 0 (canonical frame = episode 0)."""
    for k, v in rend.rendervar.items():
        tree[f"obj/{k}"] = np.asarray(v)
    for k, v in rend.table_rendervar.items():
        tree[f"table/{k}"] = np.asarray(v)
    tree["bones0"] = to_numpy(rend.state["x"])
    tree["mask"] = np.asarray(rend.total_mask_full)
    art = rend.articulation
    tree.update({"articulation/link_ids": np.asarray(art.link_ids),
                 "articulation/base_inv": to_numpy(art.base_inv),
                 "articulation/offsets": to_numpy(art.offsets),
                 "articulation/active": to_numpy(art.active),
                 "articulation/use_pusher": art.use_pusher})
    tree["qpos0"] = np.asarray(rend.qpos_curr_xarm[:7], np.float32)
    tree["use_shs"] = bool(rend.cfg.gs.get("use_shs", False))
    for key, cams, ext in (("cameras", rend.cameras, "w2c"),
                           ("wrist_cameras", rend.wrist_cameras, "eef2c")):
        for i, (w, h, k, e) in enumerate(cams):
            tree.update({f"{key}/{i}/w": w, f"{key}/{i}/h": h,
                         f"{key}/{i}/K": np.asarray(k),
                         f"{key}/{i}/{ext}": np.asarray(e)})
    ch = rend.sample_robot.chain
    tree["chain/link_names"] = np.asarray(ch.link_names)
    for k in ("parent", "joint_type", "origins", "axes", "dof_index",
              "n_dof", "topo_order", "lower", "upper"):
        tree[f"chain/{k}"] = np.asarray(getattr(ch, k))
    tree["fps"] = float(cfg.physics.fps)
    tree["do_velocity_control"] = bool(cfg.env.robot.do_velocity_control)


def _snapshot_physics(tree: dict, phys, cfg) -> None:
    """Shared physics arrays from episode 0."""
    for f in dataclasses.fields(phys.params):
        v = getattr(phys.params, f.name)
        if v is not None:
            tree[f"params/{f.name}"] = to_numpy(v)
    tree.update({f"opts/{k}": v
                 for k, v in dataclasses.asdict(phys.opts).items()})
    c = phys.colliders
    for kind, grids in (("fingers", c.fingers), ("statics", c.statics)):
        for i, g in enumerate(grids):
            for k in ("origin", "inv_spacing", "values"):
                tree[f"colliders/{kind}/{i}/{k}"] = to_numpy(getattr(g, k))
    tree["colliders/finger_pose_table"] = to_numpy(c.finger_pose_table)
    tree["finger_centroids"] = to_numpy(phys.finger_centroids)
    tree["global_translation"] = np.asarray(phys.global_translation)
    tree["force_threshold"] = float(cfg.physics.grasp_force_threshold)


def assets_tree(cfg, episode_ids, raster_config: RasterConfig | None = None,
                device="cuda"):
    """Reset one env per episode and collect the evaluator's assets.

    Returns (tree, random_variables, static_mesh_dumps): the flat numpy
    tree of ``convert.assets_from_numpy``, each episode's randomization
    draws, and each episode's world-posed static meshes (the success
    calculators' schema). ``cfg`` is updated in place as the JAX build
    updates it (checkpoint parameters, ``num_substeps``)."""
    from .. import envs

    env = envs.make(cfg.env_name, max_episode_steps=10 ** 9, cfg=cfg,
                    randomize=True, exp_root=cfg.get("exp_root", "log"),
                    raster_config=raster_config or RasterConfig(),
                    device=device)
    tree: dict = {}
    rest_x, static_poses, rel_poses, grippers, rvars, dumps, meshes = \
        [], [], [], [], [], [], []
    pose0_inv = None
    for i, ep in enumerate(episode_ids):
        with host_span("reset"):
            env.reset(seed=ep, options={"skip_obs": True})
        phys = env.unwrapped.physics
        rend = env.unwrapped.renderer
        dumps.append([{"vertices": m.vertices.copy(), "faces": m.faces.copy()}
                      for m in phys.init_meshes.values()])
        obj_pose = np.asarray(rend.pose_obj_np, np.float64)
        if i == 0:
            pose0_inv = np.linalg.inv(obj_pose)
            _snapshot_physics(tree, phys, cfg)
            _snapshot_scene(tree, rend, cfg)
        rest_x.append(phys.host_cache["rest_x"])
        static_poses.append(phys.host_cache["static_pose"])
        rel_poses.append((obj_pose @ pose0_inv).astype(np.float32))
        grippers.append(rend.grippers[0].copy())
        rvars.append(list(rend.random_variables))
        # each episode's mesh splats, posed at that episode's mesh pose
        meshes.append({name: {k: np.asarray(v) for k, v in pm.items()}
                       for name, pm in rend.params_meshes.items()})

    B = len(rest_x)
    n = rest_x[0].shape[0]
    n_f = int(tree["opts/n_fingers"])
    tree.update({
        "state/x": np.stack(rest_x),
        "state/v": np.zeros((B, n, 3), np.float32),
        "state/finger_forces": np.zeros((B, n_f, 3), np.float32),
        "state/telemetry": np.zeros((B, 4), np.int32),
        "state/current_openness": np.ones((B,), np.float32),
        "state/grasped": np.zeros((B,), bool),
        "state/initialized": np.zeros((B,), bool),
        "state/grippers": np.stack(grippers),
        "state/qpos7": np.tile(tree["qpos0"][None], (B, 1)),
        "state/rel_pose": np.stack(rel_poses),
        "state/static_pose": np.stack(static_poses),
        "state/rest_x": np.stack(rest_x),
        "state/step": 0,
    })
    for name, pm in meshes[0].items():
        for k in pm:
            tree[f"mesh_params/{name}/{k}"] = np.stack([m[name][k]
                                                       for m in meshes])
    return tree, rvars, dumps


def build_assets(cfg, episode_ids, raster_config: RasterConfig | None = None,
                 device="cuda"):
    """``BatchedAssets`` of ``cfg``'s scene for ``episode_ids``, on
    ``device``."""
    tree, rvars, dumps = assets_tree(cfg, episode_ids, raster_config, device)
    return dataclasses.replace(assets_from_numpy(tree, device),
                               random_variables=rvars,
                               static_mesh_dumps=dumps)
