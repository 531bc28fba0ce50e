"""URDF parsing into flat kinematic tables (host-side numpy).

Counterpart of the JAX package's utils/urdf.py: links and joints in
document order (integer link ids match the scan masks' ids), every
non-fixed joint one DOF, collision geometry as mesh files (loaded
relative to the URDF's directory, with the element's ``scale``) or
primitives resolved to meshes.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .mesh import TriMesh, load_mesh, make_box, make_cylinder, make_sphere

BUILTIN_URDF = str(Path(__file__).resolve().parent.parent / "assets"
                   / "simple_arm.urdf")


def resolve_geometry(spec, root_dir: Path | str = ".") -> TriMesh:
    """A collision-geometry spec -> TriMesh. Spec is a mesh filename
    (relative to ``root_dir``) or a primitive tuple ('box', size) /
    ('sphere', r) / ('cylinder', r, l)."""
    if isinstance(spec, str):
        return load_mesh(Path(root_dir) / spec)
    kind = spec[0]
    if kind == "box":
        return make_box(spec[1])
    if kind == "sphere":
        return make_sphere(spec[1])
    if kind == "cylinder":
        return make_cylinder(spec[1], spec[2])
    raise ValueError(f"unknown geometry spec {spec!r}")


def _floats(text: str | None, default: str) -> np.ndarray:
    return np.array([float(x) for x in (text or default).split()], np.float64)


def _rpy_to_mat(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def _origin_to_se3(elem: ET.Element | None) -> np.ndarray:
    T = np.eye(4)
    if elem is not None:
        T[:3, :3] = _rpy_to_mat(_floats(elem.get("rpy"), "0 0 0"))
        T[:3, 3] = _floats(elem.get("xyz"), "0 0 0")
    return T


@dataclass
class UrdfJoint:
    name: str
    type: str                      # revolute | prismatic | continuous | fixed
    parent: str
    child: str
    origin: np.ndarray             # (4, 4)
    axis: np.ndarray               # (3,)
    lower: float = 0.0
    upper: float = 0.0
    mimic_joint: str | None = None
    mimic_multiplier: float = 1.0
    mimic_offset: float = 0.0


@dataclass
class UrdfLink:
    name: str
    # (mesh file or primitive spec, scale, origin_se3) per element
    collision_meshes: list = field(default_factory=list)
    visual_meshes: list = field(default_factory=list)


@dataclass
class UrdfModel:
    name: str
    links: list                    # document order (= scan-mask link ids)
    joints: list                   # document order
    root_dir: Path

    def link_index(self, name: str) -> int:
        for i, lk in enumerate(self.links):
            if lk.name == name:
                return i
        raise KeyError(name)

    @property
    def link_names(self) -> list[str]:
        return [lk.name for lk in self.links]

    @property
    def actuated_joints(self) -> list[UrdfJoint]:
        return [j for j in self.joints if j.type != "fixed"]

    def load_collision_mesh(self, link_name: str):
        """(first collision mesh of the link, scaled, in its own frame;
        the collision origin), or None for a link without one."""
        link = self.links[self.link_index(link_name)]
        if not link.collision_meshes:
            return None
        spec, scale, origin = link.collision_meshes[0]
        mesh = resolve_geometry(spec, self.root_dir)
        if scale != 1.0:
            mesh.scale(scale)
        return mesh, origin

    def collision_offset(self, link_name: str) -> np.ndarray:
        link = self.links[self.link_index(link_name)]
        if link.collision_meshes:
            return link.collision_meshes[0][2]
        return np.eye(4)


def _geometry_spec(geom: ET.Element):
    """(spec, scale) of a <geometry> element, or None if it has neither a
    mesh nor a known primitive."""
    mesh_el = geom.find("mesh")
    if mesh_el is not None:
        fname = mesh_el.get("filename", "").replace("package://", "")
        scale_attr = mesh_el.get("scale")
        return fname, float(scale_attr.split()[0]) if scale_attr else 1.0
    if (box := geom.find("box")) is not None:
        return ("box", tuple(_floats(box.get("size"), "0.1 0.1 0.1"))), 1.0
    if (sph := geom.find("sphere")) is not None:
        return ("sphere", float(sph.get("radius", "0.05"))), 1.0
    if (cyl := geom.find("cylinder")) is not None:
        return ("cylinder", float(cyl.get("radius", "0.05")),
                float(cyl.get("length", "0.1"))), 1.0
    return None


def load_urdf(path) -> UrdfModel:
    path = Path(path)
    root = ET.parse(path).getroot()
    links, joints = [], []
    for elem in root:
        if elem.tag == "link":
            link = UrdfLink(name=elem.get("name"))
            for kind, store in (("collision", link.collision_meshes),
                                ("visual", link.visual_meshes)):
                for coll in elem.findall(kind):
                    geom = coll.find("geometry")
                    spec = _geometry_spec(geom) if geom is not None else None
                    if spec is not None:
                        store.append((spec[0], spec[1],
                                      _origin_to_se3(coll.find("origin"))))
            links.append(link)
        elif elem.tag == "joint":
            axis = elem.find("axis")
            j = UrdfJoint(
                name=elem.get("name"), type=elem.get("type", "fixed"),
                parent=elem.find("parent").get("link"),
                child=elem.find("child").get("link"),
                origin=_origin_to_se3(elem.find("origin")),
                axis=_floats(axis.get("xyz") if axis is not None else None,
                             "1 0 0"))
            limit = elem.find("limit")
            if limit is not None:
                j.lower = float(limit.get("lower", "0"))
                j.upper = float(limit.get("upper", "0"))
            mimic = elem.find("mimic")
            if mimic is not None:
                j.mimic_joint = mimic.get("joint")
                j.mimic_multiplier = float(mimic.get("multiplier", "1"))
                j.mimic_offset = float(mimic.get("offset", "0"))
            joints.append(j)
    return UrdfModel(name=root.get("name", "robot"), links=links,
                     joints=joints, root_dir=path.parent)
