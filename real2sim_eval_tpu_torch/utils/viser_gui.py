"""Live in-browser viewer with camera control, on the Python stdlib alone.

A copy of the JAX package's utils/viser_gui.py: an MJPEG streamer whose
frames a renderer pushes with ``set_output``; any browser pointed at the
port sees the stream, and mouse drag / wheel drive an orbit camera through
the ``/camera`` endpoint, which the renderer reads back through
``get_metadata()`` before each frame (``visualize_scan.serve_orbit``).
Frames are JPEG-encoded by cv2, else PIL.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = b"""<html><head><title>real2sim live</title></head>
<body style="margin:0;background:#111;color:#eee;font-family:monospace">
<div style="padding:8px">real2sim live view &mdash;
drag to orbit, wheel to zoom</div>
<img id="view" src="/stream" style="width:100%" draggable="false"/>
<script>
let az = 0.0, el = 0.6, dist = 1.0, drag = null, t = null;
function send() {
  clearTimeout(t);
  t = setTimeout(() => fetch(`/camera?az=${az}&el=${el}&dist=${dist}`), 30);
}
const v = document.getElementById('view');
v.onmousedown = e => { drag = [e.clientX, e.clientY]; e.preventDefault(); };
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  az += (e.clientX - drag[0]) * 0.01;
  el = Math.min(1.5, Math.max(-1.5, el + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY];
  send();
};
v.onwheel = e => {
  dist = Math.min(5, Math.max(0.15, dist * (e.deltaY > 0 ? 1.1 : 0.9)));
  e.preventDefault(); send();
};
</script>
</body></html>"""


def orbit_w2c(azimuth: float, elevation: float, distance: float,
              target) -> np.ndarray:
    """World-to-camera of an orbit camera looking at ``target``; the +z
    camera axis points at the target."""
    target = np.asarray(target, np.float64)
    ce, se = np.cos(elevation), np.sin(elevation)
    ca, sa = np.cos(azimuth), np.sin(azimuth)
    eye = target + distance * np.array([ce * ca, ce * sa, se])
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, -1.0])
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])          # rows: camera axes in world
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    return w2c.astype(np.float32)


class ViserViewer:
    """The reference's ViserViewer surface over the MJPEG server."""

    def __init__(self, device=None, port: int = 6789, w: int = 848, h: int = 480):
        self.port = int(port)
        self._frame: np.ndarray | None = None
        self._frame_lock = threading.Lock()
        self._fps = 0.0
        self._w, self._h = w, h
        self._metadata: dict = {}
        self._target = None
        self._server = None
        # client wheel distances are ~[0.15, 5]; scan-sized scenes set this
        # to their bounding radius so dist=1 frames the whole splat cloud
        self.dist_scale = 1.0
        self._start_server()

    # -- reference API --------------------------------------------------

    def get_metadata(self) -> dict:
        with self._frame_lock:
            return dict(self._metadata)

    def set_metadata(self, w, h, k, w2c) -> None:
        with self._frame_lock:
            self._metadata = {"w": w, "h": h, "k": k, "w2c": w2c}
            self._target = None

    def set_orbit(self, azimuth: float, elevation: float,
                  distance: float) -> None:
        """Client camera control: replace the metadata w2c with an orbit
        pose around the current target (kept from the last set_metadata's
        look-at point, else the origin)."""
        with self._frame_lock:
            if not self._metadata:
                return
            if self._target is None:
                # look-at point of the initial camera: ~0.7 m along +z axis
                w2c = np.asarray(self._metadata["w2c"], np.float64)
                R, t = w2c[:3, :3], w2c[:3, 3]
                eye = -R.T @ t
                self._target = eye + R.T @ np.array([0.0, 0.0, 0.7])
            self._metadata["w2c"] = orbit_w2c(
                azimuth, elevation, distance * self.dist_scale, self._target)

    def set_output(self, output: dict) -> None:
        img = np.asarray(output["image"])
        with self._frame_lock:
            self._frame = img

    def set_fps(self, fps: float) -> None:
        self._fps = float(fps)

    def update(self) -> None:
        pass  # frames are pulled by connected clients

    # -- server ---------------------------------------------------------

    def _start_server(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                if self.path == "/":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)
                    return
                if self.path.startswith("/camera"):
                    q = parse_qs(urlparse(self.path).query)

                    def f(name, default):
                        try:
                            return float(q[name][0])
                        except (KeyError, ValueError):
                            return default
                    viewer.set_orbit(f("az", 0.0), f("el", 0.6),
                                     f("dist", 1.0))
                    self.send_response(204)
                    self.end_headers()
                    return
                if self.path != "/stream":
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                try:
                    while True:
                        with viewer._frame_lock:
                            frame = viewer._frame
                        if frame is not None:
                            jpg = _encode_jpeg(frame)
                            self.wfile.write(b"--frame\r\n")
                            self.wfile.write(b"Content-Type: image/jpeg\r\n\r\n")
                            self.wfile.write(jpg)
                            self.wfile.write(b"\r\n")
                        time.sleep(1.0 / 30.0)
                except (BrokenPipeError, ConnectionResetError):
                    return

        try:
            self._server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        except OSError:
            self._server = ThreadingHTTPServer(("0.0.0.0", 0), Handler)
        self.port = self._server.server_port
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()

    def close(self):
        if self._server is not None:
            self._server.shutdown()


def _encode_jpeg(img: np.ndarray) -> bytes:
    try:
        import cv2

        ok, buf = cv2.imencode(".jpg", img[:, :, ::-1])
        if ok:
            return buf.tobytes()
    except ImportError:
        pass
    from io import BytesIO

    from PIL import Image

    bio = BytesIO()
    Image.fromarray(img).save(bio, format="JPEG")
    return bio.getvalue()
