"""Triangle meshes on the host (numpy): loading, sampling, transforms.

Counterpart of the JAX package's utils/mesh.py: ``TriMesh``, the
primitives, the OBJ / STL / PLY loaders, ``merge_meshes`` and
``save_obj``, with the same sampling order so a seeded build gives the
same samples.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class TriMesh:
    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray     # (F, 3) int32

    def copy(self) -> "TriMesh":
        return TriMesh(self.vertices.copy(), self.faces.copy())

    @property
    def triangles(self) -> np.ndarray:
        """open3d-compatible alias of ``faces``."""
        return self.faces

    def transform(self, T: np.ndarray) -> "TriMesh":
        """Apply a 4x4 transform in place; returns self (open3d-style)."""
        self.vertices = (self.vertices @ np.asarray(T[:3, :3]).T
                         + np.asarray(T[:3, 3]))
        return self

    def translated(self, t: np.ndarray) -> "TriMesh":
        return TriMesh(self.vertices + np.asarray(t, np.float32), self.faces)

    def scale(self, s: float, center=(0.0, 0.0, 0.0)) -> "TriMesh":
        c = np.asarray(center, np.float32)
        self.vertices = (self.vertices - c) * float(s) + c
        return self

    def _cross(self) -> np.ndarray:
        v, f = self.vertices, self.faces
        return np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])

    def face_normals(self) -> np.ndarray:
        n = self._cross()
        return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    def face_areas(self) -> np.ndarray:
        return 0.5 * np.linalg.norm(self._cross(), axis=-1)

    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def sample_surface(self, n: int, rng: np.random.Generator | None = None,
                       return_normals: bool = False):
        """Uniform-by-area surface sampling."""
        rng = rng or np.random.default_rng(0)
        areas = self.face_areas()
        probs = areas / max(areas.sum(), 1e-12)
        fidx = rng.choice(len(self.faces), size=n, p=probs)
        u = rng.random(n)
        v = rng.random(n)
        flip = u + v > 1.0
        u = np.where(flip, 1.0 - u, u)
        v = np.where(flip, 1.0 - v, v)
        tri = self.vertices[self.faces[fidx]]
        pts = (tri[:, 0] + u[:, None] * (tri[:, 1] - tri[:, 0])
               + v[:, None] * (tri[:, 2] - tri[:, 0]))
        if return_normals:
            return (pts.astype(np.float32),
                    self.face_normals()[fidx].astype(np.float32))
        return pts.astype(np.float32)

    def sample_surface_poisson(self, n: int,
                               rng: np.random.Generator | None = None
                               ) -> np.ndarray:
        """Approximate Poisson-disk sampling: oversample by area, then
        greedily grid-thin to ~n well-spread points."""
        rng = rng or np.random.default_rng(0)
        dense = self.sample_surface(max(n * 10, 1000), rng)
        lo, hi = dense.min(0), dense.max(0)
        extent = float(np.max(hi - lo)) + 1e-9
        # target spacing from blue-noise packing density on a surface
        area = float(self.face_areas().sum())
        r = np.sqrt(area / (2.0 * np.sqrt(3.0) * max(n, 1)))
        cell = max(r, extent * 1e-4)
        keys = np.floor((dense - lo) / cell).astype(np.int64)
        flat = (keys[:, 0] * 73856093 ^ keys[:, 1] * 19349663
                ^ keys[:, 2] * 83492791)
        _, first = np.unique(flat, return_index=True)
        pts = dense[np.sort(first)]
        if len(pts) > n:
            pts = pts[rng.choice(len(pts), n, replace=False)]
        return pts.astype(np.float32)


def merge_meshes(meshes: list[TriMesh]) -> TriMesh:
    verts, faces, off = [], [], 0
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + off)
        off += len(m.vertices)
    return TriMesh(np.concatenate(verts, 0).astype(np.float32),
                   np.concatenate(faces, 0).astype(np.int32))


def make_box(extents=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)) -> TriMesh:
    ex, ey, ez = [e / 2.0 for e in extents]
    c = np.asarray(center, np.float32)
    v = np.array(
        [[-ex, -ey, -ez], [ex, -ey, -ez], [ex, ey, -ez], [-ex, ey, -ez],
         [-ex, -ey, ez], [ex, -ey, ez], [ex, ey, ez], [-ex, ey, ez]],
        np.float32) + c
    f = np.array(
        [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
         [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]],
        np.int32)
    return TriMesh(v, f)


def make_sphere(radius=0.5, center=(0, 0, 0), n_lat=16, n_lon=32) -> TriMesh:
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    verts = [np.array([0.0, 0.0, radius])]
    for la in lat[1:-1]:
        for lo in lon:
            verts.append(radius * np.array(
                [np.sin(la) * np.cos(lo), np.sin(la) * np.sin(lo),
                 np.cos(la)]))
    verts.append(np.array([0.0, 0.0, -radius]))
    verts = np.asarray(verts, np.float32) + np.asarray(center, np.float32)

    def ring(i):
        return 1 + (i - 1) * n_lon

    faces = []
    for j in range(n_lon):
        faces.append([0, ring(1) + j, ring(1) + (j + 1) % n_lon])
    for i in range(1, n_lat - 1):
        for j in range(n_lon):
            a, b = ring(i) + j, ring(i) + (j + 1) % n_lon
            c, d = ring(i + 1) + j, ring(i + 1) + (j + 1) % n_lon
            faces.append([a, c, b])
            faces.append([b, c, d])
    last = len(verts) - 1
    for j in range(n_lon):
        faces.append([last, ring(n_lat - 1) + (j + 1) % n_lon,
                      ring(n_lat - 1) + j])
    return TriMesh(verts, np.asarray(faces, np.int32))


def make_cylinder(radius: float, length: float, n: int = 24) -> TriMesh:
    """Capped cylinder along z, centred at the origin (URDF primitive)."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], -1)
    bot = np.concatenate([ring, np.full((n, 1), -length / 2)], -1)
    top = np.concatenate([ring, np.full((n, 1), length / 2)], -1)
    verts = np.concatenate([bot, top, [[0, 0, -length / 2]],
                            [[0, 0, length / 2]]], 0)
    faces = []
    cb, ct = 2 * n, 2 * n + 1
    for i in range(n):
        j = (i + 1) % n
        faces += [[i, j, n + i], [j, n + j, n + i],
                  [cb, j, i], [ct, n + i, n + j]]
    return TriMesh(verts.astype(np.float32), np.asarray(faces, np.int32))


# ---------------------------------------------------------------------------
# file loading
# ---------------------------------------------------------------------------


def load_mesh(path: str | Path) -> TriMesh:
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".obj":
        return load_obj(path)
    if suffix == ".stl":
        return load_stl(path)
    if suffix == ".ply":
        return load_ply_mesh(path)
    raise ValueError(f"unsupported mesh format: {path}")


def load_obj(path: str | Path) -> TriMesh:
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def _weld(tri_verts: np.ndarray) -> TriMesh:
    """Per-triangle corners -> shared vertices (an STL has no index)."""
    verts, inverse = np.unique(tri_verts.round(7), axis=0,
                               return_inverse=True)
    return TriMesh(verts.astype(np.float32),
                   inverse.reshape(-1, 3).astype(np.int32))


def load_stl(path: str | Path) -> TriMesh:
    with open(path, "rb") as f:
        head = f.read(80)
        rest = f.read()
    if head[:5].lower() == b"solid" and b"facet" in rest[:500]:
        return _load_stl_ascii(path)
    (n_tri,) = struct.unpack("<I", rest[:4])
    record = np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)),
                       ("attr", "<u2")])
    body = np.frombuffer(rest[4:4 + record.itemsize * n_tri], dtype=record,
                         count=n_tri)
    return _weld(body["v"].reshape(-1, 3))


def _load_stl_ascii(path) -> TriMesh:
    tri_verts = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            tokens = line.split()
            if tokens and tokens[0] == "vertex":
                tri_verts.append([float(tokens[1]), float(tokens[2]),
                                  float(tokens[3])])
    return _weld(np.asarray(tri_verts, np.float32))


def load_ply_mesh(path: str | Path) -> TriMesh:
    """Minimal ascii / binary PLY mesh reader (vertex + face list)."""
    from .ply import _PLY_TO_NP

    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY")
        fmt = None
        elements = []
        props: list = []
        while True:
            tokens = f.readline().decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                props = []
                elements.append((tokens[1], int(tokens[2]), props))
            elif tokens[0] == "property":
                props.append(tokens)
            elif tokens[0] == "end_header":
                break
        endian = "<" if fmt and "little" in fmt else ">"
        verts = faces = None
        for name, count, props in elements:
            if name == "vertex":
                if fmt == "ascii":
                    data = np.loadtxt(f, max_rows=count, dtype=np.float64)
                    verts = np.atleast_2d(data)[:, :3].astype(np.float32)
                else:
                    dtype = np.dtype([(p[2], endian + _PLY_TO_NP[p[1]])
                                      for p in props])
                    tab = np.frombuffer(f.read(dtype.itemsize * count),
                                        dtype=dtype)
                    verts = np.stack([tab["x"], tab["y"], tab["z"]],
                                     -1).astype(np.float32)
            elif name == "face":
                faces_list = []
                if fmt == "ascii":
                    for _ in range(count):
                        nums = f.readline().split()
                        k = int(nums[0])
                        idx = list(map(int, nums[1:1 + k]))
                        for j in range(1, k - 1):
                            faces_list.append([idx[0], idx[j], idx[j + 1]])
                else:
                    cnt_t = endian + _PLY_TO_NP[props[0][2]]
                    idx_t = endian + _PLY_TO_NP[props[0][3]]
                    cnt_size = np.dtype(cnt_t).itemsize
                    idx_size = np.dtype(idx_t).itemsize
                    for _ in range(count):
                        k = int(np.frombuffer(f.read(cnt_size), cnt_t)[0])
                        idx = np.frombuffer(f.read(idx_size * k),
                                            idx_t).astype(int)
                        for j in range(1, k - 1):
                            faces_list.append([idx[0], idx[j], idx[j + 1]])
                faces = np.asarray(faces_list, np.int32)
        if verts is None:
            raise ValueError("PLY has no vertex element")
        if faces is None:
            faces = np.zeros((0, 3), np.int32)
        return TriMesh(verts, faces)


def save_obj(mesh: TriMesh, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in mesh.faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
