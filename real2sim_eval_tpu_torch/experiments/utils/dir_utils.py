"""Run-directory management (the JAX package's experiments/utils/dir_utils.py)."""

from __future__ import annotations

import shutil
import sys
from pathlib import Path


def mkdir(path: Path, resume: bool = False, overwrite: bool = False,
          interactive: bool = True) -> None:
    """Create a run directory. If it exists: resume leaves it, overwrite
    clears it, otherwise ask (or fail when non-interactive)."""
    path = Path(path)
    if path.exists():
        if resume:
            return
        if not overwrite:
            if interactive and sys.stdin.isatty():
                ans = input(f"{path} exists. overwrite? [y/N] ").strip().lower()
                if ans != "y":
                    print("aborting")
                    sys.exit(1)
            else:
                raise FileExistsError(
                    f"{path} exists (pass resume=True or overwrite=True)")
        shutil.rmtree(path)
    path.mkdir(parents=True, exist_ok=True)
