"""Scene assets from numpy: the bridge from a host-side asset build.

``assets_from_numpy(tree, device)`` turns a flat dict of numpy arrays
(keys joined with "/") into the evaluator's ``BatchedAssets``. The dict
holds what a JAX ``BatchedEvaluator`` sets up in ``__init__`` and
``_snapshot_scene`` (the tests build it from one), or what
``testing.make_flagship_assets`` generates. Keys:

  params/<field>             SpringMassParams fields (cand_invalid optional)
  opts/<field>               PhysicsOptions fields (python scalars)
  colliders/fingers/<i>/{origin,inv_spacing,values}
  colliders/statics/<i>/{origin,inv_spacing,values}
  colliders/finger_pose_table
  finger_centroids, global_translation, force_threshold, fps, use_shs,
  do_velocity_control, qpos0, bones0, mask
  obj/<attr>, table/<attr>, mesh_params/<name>/<attr>
      attr in means3D, rotations, shs, scales, opacities; a mesh's
      leaves are shared (N_m, ...) or per lane (B, N_m, ...): each lane's
      splats at its own episode's mesh pose (a config build's)
  cameras/<i>/{w,h,K,w2c}, wrist_cameras/<i>/{w,h,K,eef2c}
  chain/{link_names,parent,joint_type,origins,axes,dof_index,n_dof,
         topo_order,lower,upper}
  articulation/{link_ids,base_inv,offsets,active,use_pusher}
  state/{x,v,finger_forces,telemetry,current_openness,grasped,
         initialized,grippers,qpos7,rel_pose,static_pose,rest_x,step}
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .kinematics.chain import KinematicChain
from .parallel.batched import BatchedAssets, BatchedState
from .physics.dynamics import GraspState
from .physics.sdf import SdfGrid
from .physics.spring_mass import (MeshColliderSet, PhysicsOptions,
                                  SpringMassParams, SpringMassState)
from .renderer.scene import RobotArticulation

SPLAT_ATTRS = ("means3D", "rotations", "shs", "scales", "opacities")


def _nest(tree: dict) -> dict:
    out: dict = {}
    for key, val in tree.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def _indexed(node: dict) -> list:
    return [node[k] for k in sorted(node, key=int)] if node else []


def assets_from_numpy(tree: dict, device) -> BatchedAssets:
    """Flat numpy dict -> BatchedAssets with every tensor on ``device``."""
    dev = torch.device(device)
    t = _nest(tree)

    def T(a, dtype=None):
        a = np.array(a)          # writable copy: torch shares the buffer
        if dtype is None:
            dtype = {np.dtype(np.float64): torch.float32}.get(a.dtype)
        return torch.as_tensor(a, device=dev, dtype=dtype)

    def f32(a):
        return T(np.asarray(a, np.float32))

    opt_fields = {f.name for f in dataclasses.fields(PhysicsOptions)}
    opts = PhysicsOptions(**{k: v.item() if isinstance(v, np.ndarray) else v
                             for k, v in t["opts"].items()
                             if k in opt_fields})
    p = t["params"]
    params = SpringMassParams(
        **{f.name: (T(p[f.name]) if f.name in p else None)
           for f in dataclasses.fields(SpringMassParams)})

    def grid(g):
        return SdfGrid.from_values(g["origin"], float(g["inv_spacing"]),
                                   g["values"], dev)

    c = t["colliders"]
    fingers = tuple(grid(g) for g in _indexed(c.get("fingers", {})))
    statics = tuple(grid(g) for g in _indexed(c.get("statics", {})))
    s = t["state"]
    state = BatchedState(
        sm=SpringMassState(x=f32(s["x"]), v=f32(s["v"]),
                           finger_forces=f32(s["finger_forces"]),
                           telemetry=T(s["telemetry"], torch.int32)),
        grasp=GraspState(current_openness=f32(s["current_openness"]),
                         grasped=T(s["grasped"], torch.bool),
                         initialized=T(s["initialized"], torch.bool)),
        grippers=f32(s["grippers"]), qpos7=f32(s["qpos7"]),
        rel_pose=f32(s["rel_pose"]), static_pose=f32(s["static_pose"]),
        rest_x=f32(s["rest_x"]), step=int(s["step"]))
    colliders = MeshColliderSet(
        fingers=fingers, finger_pose_table=f32(c["finger_pose_table"]),
        statics=statics, static_pose=state.static_pose)

    ch = t["chain"]
    chain = KinematicChain(
        link_names=tuple(str(n) for n in ch["link_names"]),
        parent=np.asarray(ch["parent"], np.int32),
        joint_type=np.asarray(ch["joint_type"], np.int32),
        origins=np.asarray(ch["origins"], np.float64),
        axes=np.asarray(ch["axes"], np.float64),
        dof_index=np.asarray(ch["dof_index"], np.int32),
        n_dof=int(ch["n_dof"]),
        topo_order=np.asarray(ch["topo_order"], np.int32),
        lower=np.asarray(ch["lower"], np.float64),
        upper=np.asarray(ch["upper"], np.float64))
    ar = t["articulation"]
    articulation = RobotArticulation(
        chain=chain, link_ids=tuple(int(i) for i in ar["link_ids"]),
        base_inv=f32(ar["base_inv"]), offsets=f32(ar["offsets"]),
        active=T(ar["active"], torch.bool),
        use_pusher=bool(ar["use_pusher"]))

    def splats(node):
        return {k: f32(node[k]) for k in SPLAT_ATTRS}

    def cams(node, key):
        return [(int(cm["w"]), int(cm["h"]), np.asarray(cm["K"], np.float32),
                 np.asarray(cm[key], np.float32)) for cm in _indexed(node)]

    return BatchedAssets(
        params=params, opts=opts, colliders=colliders,
        finger_centroids=f32(t["finger_centroids"]),
        global_translation=f32(t["global_translation"]),
        force_threshold=float(t["force_threshold"]),
        obj=splats(t["obj"]), bones0=f32(t["bones0"]),
        table=splats(t["table"]), mask=T(t["mask"], torch.int32),
        mesh_params={name: splats(node)
                     for name, node in t.get("mesh_params", {}).items()},
        qpos0=f32(t["qpos0"]),
        cameras=cams(t.get("cameras", {}), "w2c"),
        wrist_cameras=cams(t.get("wrist_cameras", {}), "eef2c"),
        chain=chain, articulation=articulation,
        use_shs=bool(t["use_shs"]), fps=float(t["fps"]),
        do_velocity_control=bool(t["do_velocity_control"]), state=state)
