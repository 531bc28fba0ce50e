"""Rollout start/final grid images (the JAX package's
experiments/utils/visualize_rollouts.py): tile each camera's episode start
and final frames, as an evaluation CLI writes them under
``start_images/`` and ``final_images/``, into one overview image per
camera. Host code only (PIL).

Usage:
  python -m real2sim_eval_tpu_torch.experiments.utils.visualize_rollouts \\
      --data_dir log/experiments/output_eval_policy/<run>
"""

from __future__ import annotations

import argparse
import glob
import math
import re
from pathlib import Path

from PIL import Image


def collect_frames(run_dir: Path, which: str, cam_id: int) -> list[Path]:
    pattern = str(run_dir / f"{which}_images" / f"episode_*_camera_{cam_id}.jpg")
    return sorted(glob.glob(pattern))


def make_grid(paths: list[Path], cols: int | None = None,
              thumb_w: int = 212) -> Image.Image:
    n = len(paths)
    cols = cols or max(1, math.ceil(math.sqrt(n)))
    rows = math.ceil(n / cols)
    first = Image.open(paths[0])
    scale = thumb_w / first.width
    tw, th = thumb_w, int(first.height * scale)
    grid = Image.new("RGB", (cols * tw, rows * th), (20, 20, 20))
    for i, p in enumerate(paths):
        img = Image.open(p).resize((tw, th))
        grid.paste(img, ((i % cols) * tw, (i // cols) * th))
    return grid


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--cols", type=int, default=None)
    args = parser.parse_args(argv)
    run_dir = Path(args.data_dir)

    cam_ids = sorted({
        int(re.search(r"camera_(\d+)", p).group(1))
        for p in glob.glob(str(run_dir / "start_images" / "*.jpg"))
    })
    for which in ("start", "final"):
        for cam_id in cam_ids:
            paths = collect_frames(run_dir, which, cam_id)
            if not paths:
                continue
            grid = make_grid(paths, args.cols)
            out = run_dir / f"{which}_grid_camera_{cam_id}.jpg"
            grid.save(out)
            print(f"wrote {out} ({len(paths)} episodes)")


if __name__ == "__main__":
    main()
