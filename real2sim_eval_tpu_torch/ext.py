"""Build, load and count the port's CUDA kernels.

The sources live in ``csrc/``: one ``.cu`` file per kernel with a plain C
launch interface, and ``bind.cpp``, the only file that includes
``torch/extension.h``. ``load()`` compiles them in one
``torch.utils.cpp_extension.load`` call for ``sm_90a`` into ``_build/``
beside this file (listed in ``.gitignore``) at first use, and is never
called at import time: the CPU tests import every module.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds one
where it launches its kernel, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import functools
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("bind.cpp", "tile_composite.cu", "tile_backward.cu",
           "tile_sparse.cu", "tile_sparse_merge.cu", "fine_composite.cu",
           "fine_sparse.cu", "spring_mass_step.cu", "ik_solve.cu")
# no --use_fast_math, no contracted multiply-adds: the kernels follow
# their references comparison for comparison (see the sources' notes)
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a",
              "--fmad=false", "-std=c++17")

LAUNCHES = {"tile_composite": 0, "tile_composite_t": 0, "tile_backward": 0,
            "tile_sparse": 0, "tile_sparse_merge": 0, "fine_composite": 0,
            "fine_sparse": 0, "spring_mass_step": 0, "ik_solve": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def load():
    """Compile (first call) and import the extension module."""
    from torch.utils.cpp_extension import load as _load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return _load(name="real2sim_eval_tpu_torch_kernels",
                 sources=[str(CSRC / s) for s in SOURCES],
                 build_directory=str(BUILD_DIR),
                 extra_include_paths=[str(CSRC)],
                 extra_cflags=["-O3"],
                 extra_cuda_cflags=list(CUDA_FLAGS),
                 verbose=False)
