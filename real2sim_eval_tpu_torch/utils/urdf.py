"""URDF parsing into flat kinematic tables (host-side numpy).

Counterpart of the kinematic part of the JAX package's utils/urdf.py:
links and joints in document order (integer link ids match the scan masks'
ids), collision primitives resolved to meshes. Mesh files are not loaded:
the port's built-in arm uses URDF primitives only.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .mesh import TriMesh, make_box, make_cylinder, make_sphere

BUILTIN_URDF = str(Path(__file__).resolve().parent.parent / "assets"
                   / "simple_arm.urdf")


def resolve_geometry(spec) -> TriMesh:
    """A primitive spec ('box', size) / ('sphere', r) / ('cylinder', r, l)
    -> TriMesh."""
    kind = spec[0]
    if kind == "box":
        return make_box(spec[1])
    if kind == "sphere":
        return make_sphere(spec[1])
    if kind == "cylinder":
        return make_cylinder(spec[1], spec[2])
    raise ValueError(f"unsupported geometry spec {spec!r}")


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
    type: str
    parent: str
    child: str
    origin: np.ndarray
    axis: np.ndarray
    lower: float = 0.0
    upper: float = 0.0


@dataclass
class UrdfLink:
    name: str
    # (primitive spec, origin_se3) per collision element
    collisions: list = field(default_factory=list)


@dataclass
class UrdfModel:
    name: str
    links: list
    joints: list

    @property
    def link_names(self) -> list[str]:
        return [lk.name for lk in self.links]


def load_urdf(path) -> UrdfModel:
    root = ET.parse(Path(path)).getroot()
    links, joints = [], []
    for elem in root:
        if elem.tag == "link":
            link = UrdfLink(name=elem.get("name"))
            for coll in elem.findall("collision"):
                geom = coll.find("geometry")
                if geom is None:
                    continue
                origin = _origin_to_se3(coll.find("origin"))
                if geom.find("mesh") is not None:
                    raise ValueError(
                        f"link {link.name}: mesh collision geometry is not "
                        "supported by the port's URDF loader")
                if (box := geom.find("box")) is not None:
                    spec = ("box", tuple(_floats(box.get("size"),
                                                 "0.1 0.1 0.1")))
                elif (sph := geom.find("sphere")) is not None:
                    spec = ("sphere", float(sph.get("radius", "0.05")))
                elif (cyl := geom.find("cylinder")) is not None:
                    spec = ("cylinder", float(cyl.get("radius", "0.05")),
                            float(cyl.get("length", "0.1")))
                else:
                    continue
                link.collisions.append((spec, origin))
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
            joints.append(j)
    return UrdfModel(name=root.get("name", "robot"), links=links,
                     joints=joints)
