"""Video helpers (the JAX package's experiments/utils/ffmpeg.py): the
ffmpeg binary where it is on the PATH, else OpenCV's writer; with
neither, ``make_video`` raises ``ImportError`` naming both."""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path


def make_video(img_dir: Path, out_path: Path, pattern: str = "%06d.jpg",
               frame_rate: int = 30) -> None:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if shutil.which("ffmpeg"):
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "error", "-framerate", str(frame_rate),
             "-i", str(Path(img_dir) / pattern), "-c:v", "libx264",
             "-pix_fmt", "yuv420p", str(out_path)],
            check=True)
        return
    _opencv_video(img_dir, out_path, frame_rate)


def hstack_videos(paths: list[Path], out_path: Path) -> None:
    if not shutil.which("ffmpeg"):
        raise RuntimeError("ffmpeg required for hstack")
    inputs = []
    for p in paths:
        inputs += ["-i", str(p)]
    subprocess.run(
        ["ffmpeg", "-y", "-loglevel", "error", *inputs,
         "-filter_complex", f"hstack=inputs={len(paths)}", str(out_path)],
        check=True)


def _opencv_video(img_dir, out_path, frame_rate):
    try:
        import cv2
    except ImportError as e:
        raise ImportError("writing a video needs the ffmpeg binary on the "
                          "PATH or OpenCV (cv2); neither is installed") from e

    frames = sorted(Path(img_dir).glob("*.jpg")) + sorted(Path(img_dir).glob("*.png"))
    if not frames:
        return
    first = cv2.imread(str(frames[0]))
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(str(out_path), cv2.VideoWriter_fourcc(*"mp4v"),
                             frame_rate, (w, h))
    for f in frames:
        writer.write(cv2.imread(str(f)))
    writer.release()
