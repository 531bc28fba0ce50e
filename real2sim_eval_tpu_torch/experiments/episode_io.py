"""Per-episode artifact writing shared by the eval, replay and teleop tools.

The JAX package's experiments/episode_io.py on the port's tensors: the
same on-disk layout, file names and JSON keys, so the success calculators
and the reference's analysis tools read either package's runs:

  <run>/episode_XXXX/camera_K/rgb/NNNNNN.jpg
  <run>/episode_XXXX/calibration/{rvecs,tvecs,intrinsics}.npy
  <run>/episode_XXXX/robot/NNNNNN.json
  <run>/episode_XXXX/state/NNNNNN.pkl
  <run>/episode_XXXX/random_variables.json
  <run>/{start,final}_images/episode_XXXX_camera_K.jpg

A frame is written as ``(x.transpose(1, 2, 0) * 255).astype(np.uint8)``
with its channels reversed (RGB to BGR), as the JAX writer does.
``frames_uint8_bgr`` makes the same bytes for a whole batch of frames on
the frames' device, so a step copies uint8 frames to the host, a quarter
of the f32 bytes. Images are encoded by OpenCV as JPEG; writing one
raises ``ImportError`` where cv2 is missing.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np
import torch

from ..utils.device import to_numpy


def frames_uint8_bgr(frames: torch.Tensor) -> np.ndarray:
    """(..., 3, H, W) f32 frames -> host (..., H, W, 3) uint8 BGR.

    One multiply by 255 and a cast to uint8 (which truncates, as numpy's
    ``astype`` does on [0, 255]) on the frames' device, the channel
    permute and flip, then one host copy: bitwise the JAX writer's
    per-image numpy conversion."""
    return _host_bgr((frames * 255).to(torch.uint8))


def _host_bgr(u8: torch.Tensor) -> np.ndarray:
    return u8.movedim(-3, -1).flip(-1).contiguous().cpu().numpy()


def step_frames(cameras_cfg, images: torch.Tensor,
                wrist: torch.Tensor) -> list:
    """A batched step's frames for the writers: per configured camera a
    host (B, H, W, 3) uint8 BGR array, from ``images`` (B, n_fixed, 3, H, W)
    and ``wrist`` (B, n_wrist, 3, H, W). Converted on the card; where every
    camera has one resolution, one host copy for all of them."""
    u8 = camera_frames(cameras_cfg,
                       [(f * 255).to(torch.uint8) for f in images.unbind(1)],
                       [(f * 255).to(torch.uint8) for f in wrist.unbind(1)])
    if len({tuple(f.shape) for f in u8}) == 1:
        host = _host_bgr(torch.stack(u8, dim=1))
        return [host[:, k] for k in range(len(u8))]
    return [_host_bgr(f) for f in u8]


def camera_frames(cameras_cfg, fixed, wrist) -> list:
    """Pick each configured camera's frame in config order: side cameras
    take ``fixed`` in turn, wrist cameras ``wrist``
    (eval_policy.py:145-163)."""
    out, i_side, i_wrist = [], 0, 0
    for camera in cameras_cfg:
        if camera["type"] == "side":
            out.append(fixed[i_side])
            i_side += 1
        else:
            out.append(wrist[i_wrist])
            i_wrist += 1
    return out


def _write_jpeg(path: Path, img: np.ndarray) -> None:
    try:
        import cv2
    except ImportError as e:
        raise ImportError("writing JPEG frames needs OpenCV (cv2), which is "
                          "not installed") from e
    cv2.imwrite(str(path), img)


class EpisodeWriter:
    def __init__(self, run_dir: str | Path, episode_id: int, cameras_cfg,
                 save_state: bool = True):
        self.run_dir = Path(run_dir)
        self.episode_id = episode_id
        self.ep_dir = self.run_dir / f"episode_{episode_id:04d}"
        self.cameras_cfg = list(cameras_cfg)
        self.save_state = save_state
        for cam_id in range(len(self.cameras_cfg)):
            (self.ep_dir / f"camera_{cam_id}" / "rgb").mkdir(parents=True,
                                                             exist_ok=True)
        for sub in ("calibration", "robot", "state"):
            (self.ep_dir / sub).mkdir(parents=True, exist_ok=True)
        (self.run_dir / "start_images").mkdir(parents=True, exist_ok=True)
        (self.run_dir / "final_images").mkdir(parents=True, exist_ok=True)

    # -- calibration ----------------------------------------------------

    def write_calibration(self):
        from scipy.spatial.transform import Rotation as R

        rvecs, tvecs, intrs = [], [], []
        for camera in self.cameras_cfg:
            if "c2w" in camera:
                w2c = np.linalg.inv(
                    np.array(camera["c2w"], np.float32).reshape(4, 4))
            else:
                w2c = np.array(camera["w2c"], np.float32).reshape(4, 4)
            rvecs.append(R.from_matrix(w2c[:3, :3]).as_rotvec())
            tvecs.append(w2c[:3, 3])
            intrs.append(np.array(camera["intr"], np.float32).reshape(3, 3))
        cal = self.ep_dir / "calibration"
        np.save(cal / "rvecs.npy", np.stack(rvecs).reshape(-1, 3, 1))
        np.save(cal / "tvecs.npy", np.stack(tvecs).reshape(-1, 3, 1))
        np.save(cal / "intrinsics.npy", np.stack(intrs).reshape(-1, 3, 3))

    def write_random_variables(self, random_variables):
        with open(self.ep_dir / "random_variables.json", "w") as f:
            json.dump({"value": random_variables}, f, indent=4)

    # -- per-step -------------------------------------------------------

    def write_images(self, obs, step: int, overlay_fn=None,
                     start_final: str | None = None):
        """Save each camera's RGB from a single env's observation (side
        cameras consume ``image_list``, wrist cameras ``image_wrist_list``).
        Without an overlay the frames are converted on their device;
        ``overlay_fn`` gets the host f32 (3, H, W) frame, as the policy's
        other inputs are host arrays."""
        images = camera_frames(self.cameras_cfg, obs["image_list"],
                               obs["image_wrist_list"])
        if overlay_fn is not None:
            images = [overlay_fn(to_numpy(im)) for im in images]
        frames = [frames_uint8_bgr(im) if torch.is_tensor(im)
                  else (np.asarray(im).transpose(1, 2, 0) * 255).astype(
                      np.uint8)[:, :, ::-1]
                  for im in images]
        self.write_frames(frames, step, start_final)

    def write_frames(self, frames, step: int, start_final: str | None = None):
        """Save ready uint8 (H, W, 3) BGR frames, one per configured camera
        in config order (``frames_uint8_bgr`` of ``camera_frames``)."""
        for cam_id, img in enumerate(frames):
            _write_jpeg(self.ep_dir / f"camera_{cam_id}" / "rgb"
                        / f"{step:06d}.jpg", img)
            if start_final is not None:
                name = f"episode_{self.episode_id:04d}_camera_{cam_id}.jpg"
                _write_jpeg(self.run_dir / f"{start_final}_images" / name,
                            img)

    def write_robot(self, step: int, obs_pos, obs_quat, obs_gripper,
                    act_pos, act_quat, act_gripper):
        def flat(a):
            return to_numpy(a).reshape(-1).tolist()

        record = {
            "obs.ee_pos": flat(obs_pos),
            "obs.ee_quat": flat(obs_quat),
            "obs.gripper_qpos": flat(obs_gripper),
            "action.ee_pos": flat(act_pos),
            "action.ee_quat": flat(act_quat),
            "action.gripper_qpos": flat(act_gripper),
        }
        with open(self.ep_dir / "robot" / f"{step:06d}.json", "w") as f:
            json.dump(record, f, indent=4)

    def write_state(self, step: int, state: dict):
        if not self.save_state:
            return
        if step != 0 and "physics" in state:
            state = {k: v for k, v in state.items() if k != "physics"}
        # the reference's success calculators call ``.cpu().numpy()`` on
        # every leaf, so the dumps hold CPU torch tensors
        with open(self.ep_dir / "state" / f"{step:06d}.pkl", "wb") as f:
            pickle.dump(_to_state_tree(state), f)

    def finalize_videos(self, frame_rate: int = 30):
        """One video per camera from its JPEG frames."""
        from .utils.ffmpeg import make_video

        for cam_id in range(len(self.cameras_cfg)):
            make_video(self.ep_dir / f"camera_{cam_id}" / "rgb",
                       self.ep_dir / f"vis_camera_{cam_id}.mp4",
                       "%06d.jpg", frame_rate=frame_rate)


def _to_state_tree(x):
    """Array leaves -> CPU torch tensors (the reference's dump schema).

    ``torch.from_numpy`` takes float, int and bool arrays but of the
    unsigned types only uint8: any other unsigned leaf (a PRNG key, an
    index array) stays numpy, as in the JAX writer."""
    if isinstance(x, dict):
        return {k: _to_state_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_state_tree(v) for v in x)
    if hasattr(x, "shape"):
        arr = to_numpy(x)
        if arr.dtype.kind in "fib" or arr.dtype == np.uint8:
            return torch.from_numpy(np.ascontiguousarray(arr))
        return arr
    return x
