"""Hydra-style CLI entry-point helper (the JAX package's experiments/cli.py).

Gives every tool the reference's invocation surface
(``python -m ... gs=sloth physics.fps=60 ...``) without hydra: composes
``cfg/<name>.yaml`` with group and dotted overrides through the port's
config loader. ``--device`` (default ``cuda``) picks where the tool runs;
``--device cpu`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

from ..config import load_config, parse_overrides

DEFAULT_CFG_DIR = Path(__file__).resolve().parents[2] / "cfg"

# the configs' raster_backend -> the port's RasterConfig.backend: the
# TPU kernels' names select the port's kernels
RASTER_BACKENDS = {"auto": "tiles", "pallas": "tiles",
                   "reference": "reference"}


def hydra_like_main(config_name: str, config_path: str | Path | None = None):
    """Decorator: ``@hydra_like_main('replay')`` wraps ``main(cfg, device)``;
    keyword arguments of the wrapper pass through to ``main``."""

    def decorator(fn):
        def wrapper(argv=None, **kwargs):
            argv = list(sys.argv[1:] if argv is None else argv)
            parser = argparse.ArgumentParser(add_help=False)
            parser.add_argument("--config-path", default=None)
            parser.add_argument("--config-name", default=config_name)
            parser.add_argument("--device", default="cuda")
            parser.add_argument("-h", "--help", action="store_true")
            args, rest = parser.parse_known_args(argv)
            if args.help:
                print(f"usage: {fn.__module__} [--config-path DIR] "
                      f"[--config-name NAME] [--device cuda|cpu] "
                      f"[key=value ...]")
                return None
            cfg_dir = Path(args.config_path or config_path or DEFAULT_CFG_DIR)
            overrides = parse_overrides(rest)
            unknown = [a for a in rest if a not in overrides]
            if unknown:
                raise SystemExit(f"unrecognized arguments: {unknown}")
            cfg = load_config(cfg_dir, args.config_name, overrides)
            return fn(cfg, device=args.device, **kwargs)

        wrapper.__wrapped__ = fn
        return wrapper

    return decorator


def run_name_for(cfg) -> str:
    from datetime import datetime

    ts = cfg.get("timestamp")
    return ts if ts else datetime.now().strftime("%Y%m%d-%H%M%S")


def raster_config_from(cfg):
    """``RasterConfig`` of a config's ``raster_backend``: ``auto`` and
    ``pallas`` take the port's kernels (``tiles``), ``reference`` the
    dense reference; anything else raises."""
    from ..renderer import RasterConfig

    name = str(cfg.get("raster_backend", "auto"))
    if name not in RASTER_BACKENDS:
        raise ValueError(f"unknown raster_backend {name!r} "
                         f"(one of {sorted(RASTER_BACKENDS)})")
    return RasterConfig(backend=RASTER_BACKENDS[name])


class PhaseTimer:
    """Host milliseconds of a tool's phases into ``stats`` when the caller
    passes a dict, each phase closed by a synchronise of the card so that
    its card work counts to it; with ``stats`` None it times and
    synchronises nothing. While a phase runs, ``stats["current"]`` names
    it, so a counter of synchronising calls can attribute each call."""

    def __init__(self, stats: dict | None, device):
        self.stats = stats
        self.cuda = stats is not None and device.type == "cuda"

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.stats is None:
            yield
            return
        self.stats["current"] = name
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats["current"] = None
            if self.cuda:
                import torch

                torch.cuda.synchronize()
            self.stats.setdefault("ms", {}).setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)

    def mark(self, name: str, run=None) -> None:
        """Record the host clock at a point of the run (after a synchronise)
        under ``stats["marks"][name]``, then call
        ``stats["on_mark"](name, run)`` if the caller gave one; ``run`` is
        the evaluator or env the tool drives, for a caller's checks."""
        if self.stats is None:
            return
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        self.stats.setdefault("marks", {})[name] = time.perf_counter()
        if self.stats.get("on_mark") is not None:
            self.stats["on_mark"](name, run)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name`` (bytes copied, files written)."""
        if self.stats is not None:
            c = self.stats.setdefault("counts", {})
            c[name] = c.get(name, 0) + int(n)
