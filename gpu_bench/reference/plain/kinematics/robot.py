"""Robot model: URDF + link meshes + articulation tables (host numpy).

Counterpart of the JAX package's kinematics/robot.py ``RobotModel``: the
per-openness SE(3) pose tables of the gripper fingers (fingers are rigid
bodies, so one 4x4 per openness sample carries the finger's whole point
set), the links' collision meshes and their collision origins, and the
world-posed meshes and sampled point clouds of the scene-construction
tools (the same rng draws in the same order as the JAX package's, so a
seed gives the same points). The axis-angle rotation of the JAX module's
``_rot4`` is ``chain._rot4_np``, which ``fk_numpy`` runs.

Gripper openness convention: openness o in [0, 1] (1 = open); each finger
joint angle is 0.8 * (1 - o) rad.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.mesh import TriMesh
from ..utils.urdf import UrdfModel, load_urdf, resolve_geometry
from .chain import KinematicChain

# canonical arm pose used for building gripper-local tables
CANONICAL_ARM_QPOS = np.array([0, -45, 0, 30, 0, 75, 0]) * np.pi / 180.0


def openness_to_finger_angle(openness) -> np.ndarray:
    """openness in [0, 1] -> finger joint angle in radians."""
    return 0.8 * (1.0 - np.asarray(openness))


class RobotModel:
    """A URDF-backed robot with cached meshes and articulation helpers."""

    def __init__(self, urdf_path: str | Path,
                 link_names: list[str] | None = None):
        self.urdf_path = Path(urdf_path)
        self.urdf: UrdfModel = load_urdf(self.urdf_path)
        self.chain = KinematicChain.from_urdf(self.urdf)

        # collision meshes of the requested links (or all that have one)
        self.meshes: dict[str, TriMesh] = {}
        self.offsets: dict[str, np.ndarray] = {}
        prev_offset = np.eye(4)
        for link in self.urdf.links:
            if link_names is not None and link.name not in link_names:
                continue
            if link.collision_meshes:
                spec, scale, origin = link.collision_meshes[0]
                prev_offset = origin
                mesh = resolve_geometry(spec, self.urdf.root_dir)
                if scale != 1.0:
                    mesh.scale(scale)
                self.meshes[link.name] = mesh
            # a link without a collision inherits the previously seen
            # collision origin (the reference's point sampler does so)
            self.offsets[link.name] = prev_offset.copy()
        self._pcd_cache: dict[tuple, np.ndarray] = {}

    def fk_numpy(self, qpos: np.ndarray) -> np.ndarray:
        """All link poses (L, 4, 4) as float64 numpy (host precompute)."""
        return self.chain.fk_numpy(qpos)

    def full_qpos(self, arm_qpos: np.ndarray,
                  openness: float | None = None) -> np.ndarray:
        """A full DOF vector: the arm joints + every finger joint at the
        angle ``openness`` implies."""
        n_extra = self.chain.n_dof - len(arm_qpos)
        if n_extra == 0:
            return np.asarray(arm_qpos, np.float64)
        angle = float(openness_to_finger_angle(
            1.0 if openness is None else openness))
        return np.concatenate([np.asarray(arm_qpos, np.float64),
                               np.full(n_extra, angle)])

    def link_pose(self, qpos: np.ndarray, link_name: str) -> np.ndarray:
        return self.fk_numpy(qpos)[self.chain.link_index(link_name)]

    def compute_mesh_poses(self, qpos: np.ndarray,
                           link_names: list[str] | None = None) -> np.ndarray:
        """World pose of each link's collision mesh (FK @ collision
        origin)."""
        link_names = list(link_names or self.meshes.keys())
        fk = self.fk_numpy(qpos)
        return np.stack([fk[self.chain.link_index(n)] @ self.offsets[n]
                         for n in link_names])

    def eef_link_name(self) -> str:
        for cand in ("link_eef", "link7"):
            if cand in self.chain.link_names:
                return cand
        raise KeyError("no eef link found")

    def finger_pose_table(self, finger_links: list[str],
                          n_samples: int = 101,
                          arm_qpos: np.ndarray | None = None) -> np.ndarray:
        """(n_fingers, n_samples, 4, 4) mesh-frame -> eef-frame pose per
        openness sample i / (n_samples - 1). The fingers hang rigidly
        below the eef, so these depend on openness alone."""
        arm_qpos = CANONICAL_ARM_QPOS if arm_qpos is None else arm_qpos
        eef = self.chain.link_index(self.eef_link_name())
        out = np.zeros((len(finger_links), n_samples, 4, 4))
        for s in range(n_samples):
            fk = self.fk_numpy(self.full_qpos(arm_qpos,
                                              openness=s / (n_samples - 1)))
            T_ew = np.linalg.inv(fk[eef])
            for f, name in enumerate(finger_links):
                out[f, s] = (T_ew @ fk[self.chain.link_index(name)]
                             @ self.offsets[name])
        return out

    def finger_meshes(self) -> list[TriMesh]:
        """Collision meshes of the loaded links, in mesh-file frame."""
        return list(self.meshes.values())

    def finger_link_names(self) -> list[str]:
        return list(self.meshes.keys())

    def eef_points_table(self, n_samples: int = 101) -> np.ndarray:
        """(n_samples, P, 3) eef-frame mesh vertices across openness."""
        names = self.finger_link_names()
        table = self.finger_pose_table(names, n_samples)
        verts = [self.meshes[n].vertices for n in names]
        out = []
        for s in range(n_samples):
            out.append(np.concatenate(
                [v @ table[f, s][:3, :3].T + table[f, s][:3, 3]
                 for f, v in enumerate(verts)], axis=0))
        return np.stack(out).astype(np.float32)

    def get_gripper_meshes(self, gripper_openness: float = 1.0,
                           arm_qpos: np.ndarray | None = None
                           ) -> list[TriMesh]:
        """World-frame collision meshes of every loaded link at ``arm_qpos``
        (the canonical arm pose by default) and the gripper's openness."""
        arm_qpos = CANONICAL_ARM_QPOS if arm_qpos is None else arm_qpos
        q = self.full_qpos(arm_qpos, openness=gripper_openness)
        names = list(self.meshes)
        poses = self.compute_mesh_poses(q, names)
        out = []
        for i, n in enumerate(names):
            m = self.meshes[n].copy()
            m.transform(poses[i])
            out.append(m)
        return out

    def get_pusher_meshes(self, arm_qpos: np.ndarray | None = None
                          ) -> list[TriMesh]:
        return self.get_gripper_meshes(1.0, arm_qpos)

    def sample_pc(self, link_names=None, num_pts=None,
                  rng: np.random.Generator | None = None
                  ) -> dict[str, np.ndarray]:
        """Link-frame Poisson samples of each link's collision mesh, all
        drawn from one ``rng`` in link order."""
        link_names = list(link_names or self.meshes.keys())
        if num_pts is None:
            num_pts = [200] * len(link_names)
        rng = rng or np.random.default_rng(0)
        return {n: self.meshes[n].sample_surface_poisson(k, rng)
                for n, k in zip(link_names, num_pts)}

    def compute_robot_pcd(self, qpos, link_names=None, num_pts=None,
                          pcd_name: str | None = None) -> np.ndarray:
        """World-frame sampled robot point cloud at ``qpos``: link i's
        points from ``default_rng(i)``, cached by (pcd_name, link, count)
        when ``pcd_name`` is given."""
        link_names = list(link_names or self.meshes.keys())
        if num_pts is None:
            num_pts = [1000] * len(link_names)
        elif isinstance(num_pts, int):
            num_pts = [num_pts] * len(link_names)
        poses = self.compute_mesh_poses(qpos, link_names)
        pcs = []
        for i, n in enumerate(link_names):
            key = (pcd_name, n, num_pts[i])
            if pcd_name is None or key not in self._pcd_cache:
                cloud = self.meshes[n].sample_surface_poisson(
                    num_pts[i], np.random.default_rng(i))
                if pcd_name is not None:
                    self._pcd_cache[key] = cloud
            else:
                cloud = self._pcd_cache[key]
            pcs.append(cloud @ poses[i][:3, :3].T + poses[i][:3, 3])
        return np.concatenate(pcs, axis=0)
