"""Fabricate a PhysTwin checkpoint from a mesh, on the host (numpy).

Counterpart of the JAX package's experiments/utils/create_rigid_phystwin.py:
samples surface + interior points of a mesh, grid-deduplicates, connects a
dense stiff spring lattice, and writes the three-file checkpoint tree
(final_data.pkl / optimal_params.pkl / best_0.pth) through the port's
physics/checkpoints.py. The same seed gives the same points and springs
as the JAX tool.

Usage:
  python -m real2sim_eval_tpu_torch.experiments.utils.create_rigid_phystwin \\
      --mesh path/to/mesh.stl --out log/ckpt --case my_case
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ...physics.checkpoints import write_phystwin_checkpoint
from ...physics.topology import connect_springs
from ...utils.mesh import TriMesh, load_mesh, make_box


def sample_rigid_points(mesh: TriMesh, n_surface: int = 2000,
                        grid_size: float = 0.01,
                        seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Surface samples + interior grid points, deduplicated on a voxel
    grid (surface points first, each kept voxel's first point)."""
    rng = np.random.default_rng(seed)
    surface = mesh.sample_surface(n_surface, rng)

    lo, hi = mesh.bounds()
    axes = [np.arange(lo[i] + grid_size / 2, hi[i], grid_size) for i in range(3)]
    if all(len(a) for a in axes):
        grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        interior = grid[_points_inside(mesh, grid)]
    else:
        interior = np.zeros((0, 3), np.float32)

    # voxel dedupe of the union
    allpts = np.concatenate([surface, interior.astype(np.float32)], 0)
    keys = np.floor((allpts - lo) / grid_size).astype(np.int64)
    flat = keys[:, 0] * 73856093 ^ keys[:, 1] * 19349663 ^ keys[:, 2] * 83492791
    _, first = np.unique(flat, return_index=True)
    keep = np.sort(first)
    surface_keep = keep[keep < len(surface)]
    interior_keep = keep[keep >= len(surface)] - len(surface)
    return surface[surface_keep], interior[interior_keep].astype(np.float32)


def _points_inside(mesh: TriMesh, pts: np.ndarray) -> np.ndarray:
    """Ray-parity inside test along +z (adequate for closed meshes)."""
    v = mesh.vertices
    f = mesh.faces
    tri = v[f]  # (F, 3, 3)
    inside = np.zeros(len(pts), bool)
    # vectorized over triangles per point-chunk
    for start in range(0, len(pts), 512):
        p = pts[start:start + 512]
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        # 2D (xy) barycentric test per (point, tri)
        d = (b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0]) + \
            (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1])
        ok = np.abs(d) > 1e-12
        px = p[:, None, 0]
        py = p[:, None, 1]
        l1 = ((b[:, 1] - c[:, 1]) * (px - c[:, 0])
              + (c[:, 0] - b[:, 0]) * (py - c[:, 1])) / np.where(ok, d, 1.0)
        l2 = ((c[:, 1] - a[:, 1]) * (px - c[:, 0])
              + (a[:, 0] - c[:, 0]) * (py - c[:, 1])) / np.where(ok, d, 1.0)
        l3 = 1.0 - l1 - l2
        hit = ok & (l1 >= 0) & (l2 >= 0) & (l3 >= 0)
        z_hit = l1 * a[:, 2] + l2 * b[:, 2] + l3 * c[:, 2]
        above = hit & (z_hit > p[:, None, 2])
        inside[start:start + 512] = (above.sum(axis=1) % 2) == 1
    return inside


def create_rigid_phystwin(mesh: TriMesh, out_root, case_name,
                          spring_radius: float = 0.5, max_neighbours: int = 50,
                          spring_Y: float = 1e5, n_surface: int = 2000,
                          grid_size: float = 0.01, seed: int = 0):
    """Emit the checkpoint tree; returns (points, springs)."""
    surface, interior = sample_rigid_points(mesh, n_surface, grid_size, seed)
    points = np.concatenate([surface, interior], 0).astype(np.float32)
    springs, _ = connect_springs(points, spring_radius, max_neighbours)
    write_phystwin_checkpoint(
        out_root, case_name,
        object_points=points,
        surface_points=np.zeros((0, 3), np.float32),
        interior_points=np.zeros((0, 3), np.float32),
        spring_Y=np.full(len(springs), spring_Y, np.float32),
        num_object_springs=len(springs),
    )
    print(f"{case_name}: {len(points)} points "
          f"({len(surface)} surface, {len(interior)} interior), "
          f"{len(springs)} springs -> {out_root}")
    return points, springs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mesh", type=str, default=None,
                        help="mesh file; a unit test box when omitted")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--case", type=str, required=True)
    parser.add_argument("--spring_radius", type=float, default=0.5)
    parser.add_argument("--max_neighbours", type=int, default=50)
    parser.add_argument("--spring_Y", type=float, default=1e5)
    parser.add_argument("--grid_size", type=float, default=0.01)
    parser.add_argument("--n_surface", type=int, default=2000)
    args = parser.parse_args(argv)

    mesh = load_mesh(args.mesh) if args.mesh else make_box((0.06, 0.06, 0.06))
    create_rigid_phystwin(mesh, args.out, args.case,
                          spring_radius=args.spring_radius,
                          max_neighbours=args.max_neighbours,
                          spring_Y=args.spring_Y,
                          n_surface=args.n_surface,
                          grid_size=args.grid_size)


if __name__ == "__main__":
    main()
