"""Per-phase split of the spring-mass step K3 on the card, by clock64().

    python3 scripts/k3_phase_clocks.py [--tree DIR] [--reps N] [--ranks R]

Builds the port's CUDA extension from DIR (default: this checkout) with an
instrumented copy of ``csrc/spring_mass_step.cu`` in DIR/scratch/
(git-ignored; the committed kernel is never changed), runs the flagship's
K3 step (64 envs, the 1000-particle rope, 667 substeps; the state after
one control step from rest) ``--reps`` times, launched with ``--ranks``
CTAs per env (default: the main path's, ``fused_step.K3_RANKS``), and
prints one JSON line:
for each phase the mean over threads of the cycles per substep, and the
same in microseconds at the clock the run implies (the loop's cycles over
its CUDA-event time). Every thread of every CTA stamps clock64() at the
phase boundaries of each substep:

  A          springs + dashpots, gravity, drag (to the end of its writes);
  A_wait     the barrier after A (the cluster's with two CTAs per env);
  B          self-collision, its two barriers included;
  C          SDF contact of the frozen candidates (inside the particle loop);
  D          ground + integration (the rest of the particle loop);
  D_wait     the barrier that ends the substep.

A thread that owns no particle (1024 threads, 1000 particles) stamps ~0
for A, C and D and waits at the barriers. The stamps go in at ``// clock:
NAME`` lines of the source, which the script first inserts at the anchors
in ANCHORS (text of ``csrc/spring_mass_step.cu``); a source that already
carries such lines is instrumented as it is. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
import time
from pathlib import Path

PRELUDE = r'''
__device__ unsigned long long k3_clock_sums[8];

struct K3Clock {
  long long t[6];
  unsigned long long acc[7];
  __device__ void init() {
    for (int q = 0; q < 6; ++q) t[q] = 0;
    for (int q = 0; q < 7; ++q) acc[q] = 0;
  }
  __device__ void lap() {
    const long long e = clock64();
    acc[0] += t[1] - t[0];
    acc[1] += t[2] - t[1];
    acc[2] += t[3] - t[2];
    acc[4] += t[5] - t[3];
    acc[5] += e - t[5];
    acc[6] += e - t[0];
  }
  __device__ void flush() {
    for (int q = 0; q < 7; ++q) atomicAdd(&k3_clock_sums[q], acc[q]);
    atomicAdd(&k3_clock_sums[7], 1ull);
  }
};

extern "C" __attribute__((visibility("default"))) int k3_clock_read(
    unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k3_clock_sums, sizeof(k3_clock_sums));
}

extern "C" __attribute__((visibility("default"))) int k3_clock_reset() {
  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(k3_clock_sums, z, sizeof(z));
}
'''

STAMPS = {
    "init": "K3Clock k3c; k3c.init();",
    "substep": "k3c.t[0] = clock64();",
    "a_end": "k3c.t[1] = clock64();",
    "a_sync": "k3c.t[2] = clock64();",
    "b_end": "k3c.t[3] = clock64();",
    "c_begin": "k3c.t[4] = clock64();",
    "c_end": "k3c.acc[3] += clock64() - k3c.t[4];",
    "d_end": "k3c.t[5] = clock64();",
    "d_sync": "k3c.lap();",
    "flush": "k3c.flush();",
}

# (text, text with the markers) in the kernel's body (both launches)
ANCHORS = [
    ("  extern __shared__ float smem[];\n",
     "  extern __shared__ float smem[];\n  // clock: init\n"),
    ("  for (int s = 0; s < a.S; ++s) {\n",
     "  for (int s = 0; s < a.S; ++s) {\n    // clock: substep\n"),
    ("    drift(a, rank, s, 0);\n    env_barrier<R>();\n",
     "    // clock: a_end\n    drift(a, rank, s, 0);\n    env_barrier<R>();\n"
     "    // clock: a_sync\n"),
    ("    // ---- C + D: contact",
     "    // clock: b_end\n    // ---- C + D: contact"),
    ("      if (C > 0) {\n        const float nx[3]",
     "      // clock: c_begin\n      if (C > 0) {\n        const float nx[3]"),
    ("      // ground response with time-of-impact integration\n",
     "      // clock: c_end\n"
     "      // ground response with time-of-impact integration\n"),
    ("    drift(a, rank, s, 3);\n    env_barrier<R>();\n  }\n",
     "    // clock: d_end\n    drift(a, rank, s, 3);\n    env_barrier<R>();\n"
     "    // clock: d_sync\n  }\n  // clock: flush\n"),
]

PHASES = ("A", "A_wait", "B", "C", "D", "D_wait", "substep")


def instrument(src: str) -> str:
    """The K3 source with a stamp at every ``// clock: NAME`` line."""
    if "// clock: " not in src:
        for old, new in ANCHORS:
            if src.count(old) != 1:
                raise SystemExit(f"anchor not found once: {old!r}")
            src = src.replace(old, new)
    lines = []
    for line in src.splitlines():
        name = line.strip()[len("// clock: "):]
        if line.strip().startswith("// clock: "):
            lines.append(" " * (len(line) - len(line.lstrip()))
                         + STAMPS[name])
        else:
            lines.append(line)
    out = "\n".join(lines) + "\n"
    head = '#include "spring_mass_step.h"\n'
    if out.count(head) != 1:
        raise SystemExit("spring_mass_step.h is not included once")
    return out.replace(head, head + PRELUDE)


def build(tree: Path):
    """The tree's extension with the instrumented K3, and its ctypes
    handle for the clock sums."""
    from torch.utils.cpp_extension import load

    sys.path.insert(0, str(tree))
    from real2sim_eval_tpu_torch import ext

    work = tree / "scratch" / "k3_clocks"
    src = work / "csrc"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(ext.CSRC, src)
    k3 = src / "spring_mass_step.cu"
    k3.write_text(instrument(k3.read_text()))
    build_dir = work / "build"
    build_dir.mkdir(parents=True, exist_ok=True)
    mod = load(name="k3_phase_clocks_ext",
               sources=[str(src / s) for s in ext.SOURCES],
               build_directory=str(build_dir), extra_include_paths=[str(src)],
               extra_cflags=["-O3"], extra_cuda_cflags=list(ext.CUDA_FLAGS),
               verbose=False)
    lib = ctypes.CDLL(mod.__file__)
    lib.k3_clock_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    ext.load = lambda: mod                # the wrappers launch this build
    return lib


def flagship_step_inputs():
    """(opts, tables, state) of the flagship's second control step: 64
    envs, rope only (K3 reads no splats), bench.py's hold action."""
    import numpy as np
    import torch

    from real2sim_eval_tpu_torch.parallel import BatchedEvaluator
    from real2sim_eval_tpu_torch.physics import fused_step
    from real2sim_eval_tpu_torch.renderer import RasterConfig
    from real2sim_eval_tpu_torch.testing import make_flagship_assets

    B = 64
    a = make_flagship_assets(batch=B, n_table=1000, n_obj_dense=0,
                             device="cuda")
    ev = BatchedEvaluator(a, list(range(B)), device="cuda",
                          raster_config=RasterConfig(incremental="off"))
    rot = np.diag([1.0, -1.0, -1.0]).reshape(-1)
    act = torch.tensor(np.tile(np.concatenate([[0.2, 0.0, 0.3], rot, [1.0]]),
                               (B, 1)), dtype=torch.float32, device="cuda")
    ev.step(act)
    seen = {}
    orig = fused_step.spring_mass_step

    def spy(*args):
        seen.setdefault("args", args)
        return orig(*args)

    fused_step.spring_mass_step = spy
    try:
        ev.step(act)
    finally:
        fused_step.spring_mass_step = orig
    return seen["args"]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ranks", type=int, default=None,
                    help="CTAs per env: 1, or 2 (a cluster)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_phase_clocks: no CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    t0 = time.perf_counter()
    lib = build(tree)
    build_s = time.perf_counter() - t0
    from real2sim_eval_tpu_torch.physics import fused_step

    opts, tab, state = flagship_step_inputs()
    ranks = fused_step.K3_RANKS if args.ranks is None else args.ranks
    fused_step.spring_mass_step(opts, tab, state, ranks=ranks)   # warm-up
    torch.cuda.synchronize()
    if lib.k3_clock_reset():
        raise SystemExit("k3_clock_reset failed")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(args.reps):
        fused_step.spring_mass_step(opts, tab, state, ranks=ranks)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / args.reps
    sums = (ctypes.c_ulonglong * 8)()
    if lib.k3_clock_read(sums):
        raise SystemExit("k3_clock_read failed")
    threads = sums[7] / args.reps
    S = opts.num_substeps
    cyc = {name: sums[q] / (sums[7] * S)
           for name, q in zip(("A", "A_wait", "B", "C", "CD", "D_wait",
                               "substep"), range(7))}
    cyc["D"] = cyc.pop("CD") - cyc["C"]
    ghz = cyc["substep"] * S / (ms * 1e6)
    print(json.dumps({
        "tree": str(tree), "card": torch.cuda.get_device_name(0),
        "ranks": ranks,
        "build_s": build_s, "envs": int(state.x.shape[0]),
        "particles": int(state.x.shape[1]), "substeps": S,
        "threads": threads, "kernel_ms": ms, "implied_ghz": ghz,
        "cycles_per_substep": {k: cyc[k] for k in PHASES},
        "us_per_substep": {k: cyc[k] / (ghz * 1e3) for k in PHASES}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
