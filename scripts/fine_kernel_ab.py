"""The fine compositors K4 and K5 of two source trees, timed on one card.

    python3 scripts/fine_kernel_ab.py --tree DIR [--tree DIR2 ...] [--reps N]

Builds ``csrc/fine_composite.cu`` and ``csrc/fine_sparse.cu`` of this
checkout and of each DIR (another checkout of the repository, e.g. a
parent commit unpacked by ``git archive`` into a git-ignored directory)
with ``nvcc`` into shared libraries with their plain C interface (seconds:
the sources do not include PyTorch's headers), loaded through ctypes;
a tree whose ``tile_composite.h`` declares the launches without a tile
order is called without one. It then captures K4's and K5's inputs from
the fine flagship (64 envs, ``RasterConfig(kernel="fine")``, the state
after two control steps from rest; this checkout's extension builds and
runs the path), runs every tree's kernels on the same inputs in the order
A B .. B A, checks each output bitwise against this checkout's wrappers,
and prints one JSON line per run and a summary line: each tree's K4 and K5
milliseconds (CUDA events, mean of ``--reps`` launches into preallocated
frames; a tile order, where the tree takes one, sorted once outside the
timed launches), with the card's ``nvidia-smi`` name and power limit.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[], type=Path)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fine_kernel_ab: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from real2sim_eval_tpu_torch import ext
    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.renderer import RasterConfig
    from real2sim_eval_tpu_torch.renderer import fine_kernel as fk
    from real2sim_eval_tpu_torch.renderer import incremental_fine, raster
    from real2sim_eval_tpu_torch.renderer import tile_kernel as tk
    from real2sim_eval_tpu_torch.testing import make_flagship_assets

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    trees = {"this": ROOT, **{str(t): t.resolve() for t in args.tree}}
    builds = {name: cs.start_fine_lib(
        tree / "real2sim_eval_tpu_torch" / "csrc",
        ext.BUILD_DIR / "fine_ab" / f"t{k}.so")
        for k, (name, tree) in enumerate(trees.items())}
    ext.load()
    libs = {name: cs.load_fine_lib(b) for name, b in builds.items()}

    B = 64
    a = make_flagship_assets(batch=B, n_table=cs.N_TABLE,
                             n_obj_dense=cs.N_OBJ_DENSE, device="cuda")
    ev = BatchedEvaluator(a, list(range(B)), device="cuda",
                          raster_config=RasterConfig(kernel="fine"))
    actions = cs.flagship_actions()
    ev.step(actions)
    ev.render()
    ev.step(actions)
    k4, undo4 = cs.capture(raster, "rasterize_fine_batch")
    k5, undo5 = cs.capture(incremental_fine, "rasterize_fine_sparse")
    try:
        ev.render()
    finally:
        undo5()
        undo4()
    pairs, starts, ends, nsx, nsy = k4["args"][:5]
    m_pairs, inst, tile, m_st, m_en, rgb_c, dep_c, nsx5, nsy5, bg = k5["args"]
    ref4 = fk.rasterize_fine_batch(pairs, starts, ends, nsx, nsy)
    ref5 = fk.rasterize_fine_sparse(*k5["args"])
    order4 = tk.longest_first(starts, ends)
    order5 = tk.longest_first(m_st, m_en)
    rgb4, dep4 = torch.empty_like(ref4[0]), torch.empty_like(ref4[1])
    rgb5, dep5 = tk.copy_frames(rgb_c, dep_c)

    def run4(name):
        cs.fine_lib_composite(*libs[name], pairs, starts, ends, order4, nsx,
                              nsy, (0.0, 0.0, 0.0), rgb4, dep4)

    def run5(name):
        cs.fine_lib_sparse(*libs[name], m_pairs, inst, tile, m_st, m_en,
                           order5, nsx5, nsy5, bg, rgb5, dep5)

    out = {}
    names = list(libs)
    for rnd, seq in enumerate((names, names[::-1])):
        for name in seq:
            run4(name)
            run5(name)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(rgb4, ref4[0])
                           and torch.equal(dep4, ref4[1])
                           and torch.equal(rgb5, ref5[0])
                           and torch.equal(dep5, ref5[1]))
            ms4 = cs.time_cuda(lambda: run4(name), args.reps)
            ms5 = cs.time_cuda(lambda: run5(name), args.reps)
            row = {"round": rnd, "tree": name, "k4_ms": ms4, "k5_ms": ms5,
                   "bitwise": bitwise}
            print(json.dumps(row), flush=True)
            out.setdefault(name, []).append(row)
            if not bitwise:
                raise RuntimeError(f"{name}: frames differ from this "
                                   "checkout's wrappers")
    print(json.dumps({
        "nvidia_smi": smi, "fine_tiles": int(starts.numel()),
        "pairs": int(pairs.shape[1]), "dirty_fine_tiles": int(inst.numel()),
        "merged_pairs": int((m_en - m_st).sum()),
        "ms": {name: {"k4": [r["k4_ms"] for r in rows],
                      "k5": [r["k5_ms"] for r in rows]}
               for name, rows in out.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
