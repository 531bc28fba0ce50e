"""Triangle meshes on the host (numpy): the part the port's SDF build and
URDF primitives need.

Counterpart of the ``TriMesh`` / ``make_box`` / ``make_sphere`` /
``sample_surface`` part of the JAX package's utils/mesh.py, same sampling
order so a seeded build gives the same samples.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TriMesh:
    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray     # (F, 3) int32

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
