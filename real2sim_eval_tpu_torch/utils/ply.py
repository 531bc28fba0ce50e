"""PLY I/O for Gaussian-splat scans (host code).

Counterpart of the JAX package's utils/ply.py (its readers, loader, SH
layout helpers, writer and ``.splat`` export). ``read_ply_table`` reads a
binary little-endian table of float properties with the C++ reader
``csrc/host/ply_loader.cpp`` (built at first use with g++ into the
package's ``_build/``, loaded through ctypes; ``R2S_NATIVE=0`` turns it
off); other files, and every file with ``R2S_NATIVE=0``, go through the
numpy reader, which parses the header once and maps the binary payload as
one structured array. A reader that fails to build or load raises with
the compiler's message rather than falling back.

The on-disk layout is the standard 3DGS checkpoint: per-vertex
``x y z [nx ny nz] f_dc_0..2 f_rest_0..44 opacity scale_0..2 rot_0..3``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from .profiling import host_span

_PLY_TO_NP = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
}


def _read_header(f, path):
    """Parse a PLY header; returns (format, [(element, count, props)])."""
    if f.readline().strip() != b"ply":
        raise ValueError(f"{path}: not a PLY file")
    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError(f"{path}: unexpected EOF in header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            props = elements[-1][2]
            if tokens[1] == "list":
                props.append((tokens[-1], f"list:{tokens[2]}:{tokens[3]}"))
            else:
                props.append((tokens[2], _PLY_TO_NP[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt is None:
        raise ValueError(f"{path}: missing format line")
    return fmt, elements


def read_ply_vertex_table(path: str | Path) -> dict[str, np.ndarray]:
    """Read the ``vertex`` element of a PLY file into {property: (N,) array}."""
    with open(path, "rb") as f:
        fmt, elements = _read_header(f, path)
        endian = "<" if "little" in fmt else ">"
        for name, count, props in elements:
            has_list = any(t.startswith("list:") for _, t in props)
            if name == "vertex":
                if has_list:
                    raise ValueError("list properties unsupported on vertex "
                                     "element")
                if fmt == "ascii":
                    data = np.atleast_2d(np.loadtxt(f, max_rows=count,
                                                    dtype=np.float64))
                    return {p: data[:, i] for i, (p, _) in enumerate(props)}
                dtype = np.dtype([(p, endian + t) for p, t in props])
                table = np.frombuffer(f.read(dtype.itemsize * count),
                                      dtype=dtype, count=count)
                return {p: np.ascontiguousarray(table[p]) for p, _ in props}
            # skip a non-vertex element before the vertices
            if fmt == "ascii":
                for _ in range(count):
                    f.readline()
            elif has_list:
                raise ValueError("cannot skip binary list element before "
                                 "vertex")
            else:
                dtype = np.dtype([(p, endian + t) for p, t in props])
                f.seek(dtype.itemsize * count, 1)
    raise ValueError(f"{path}: no vertex element found")


_NATIVE_SRC = (Path(__file__).resolve().parents[1] / "csrc" / "host"
               / "ply_loader.cpp")
_NATIVE_SO = Path(__file__).resolve().parents[1] / "_build" / "libr2s_ply.so"
_NATIVE: list = []            # the loaded library, once


def _native_lib():
    """The C++ reader, built (when missing or older than its source) and
    loaded on first use; raises with the compiler's or loader's message."""
    if _NATIVE:
        return _NATIVE[0]
    so = _NATIVE_SO
    if not so.exists() or so.stat().st_mtime < _NATIVE_SRC.stat().st_mtime:
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                            "-o", str(tmp), str(_NATIVE_SRC)], check=True,
                           capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            msg = getattr(e, "stderr", None) or e
            raise RuntimeError(f"building the native PLY reader "
                               f"{_NATIVE_SRC} failed: {msg}") from e
        os.replace(tmp, so)          # atomic: concurrent builds agree
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        raise RuntimeError(f"loading the native PLY reader {so} failed: "
                           f"{e}") from e
    lib.ply_probe.restype = ctypes.c_int
    lib.ply_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                              ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                              ctypes.c_long]
    lib.ply_read.restype = ctypes.c_int
    lib.ply_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
    _NATIVE.append(lib)
    return lib


def read_ply_vertex_table_native(path) -> dict[str, np.ndarray] | None:
    """The vertex table by the C++ reader, every column float32 (f64
    properties rounded); None for a file it does not handle (not binary
    little-endian, or a list property)."""
    lib = _native_lib()
    n_verts = ctypes.c_long()
    n_props = ctypes.c_int()
    names_buf = ctypes.create_string_buffer(16384)
    p = str(path).encode()
    if lib.ply_probe(p, ctypes.byref(n_verts), ctypes.byref(n_props),
                     names_buf, len(names_buf)):
        return None
    out = np.empty((n_verts.value, n_props.value), np.float32)
    if lib.ply_read(p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))):
        raise OSError(f"{path}: the native PLY reader could not read the "
                      "vertex payload")
    names = names_buf.value.decode().split(",")
    return {name: out[:, i] for i, name in enumerate(names)}


def read_ply_table(path: str | Path) -> tuple[dict[str, np.ndarray], int]:
    """Raw vertex property table of a PLY: (name -> (N,) column, N); the
    C++ reader's unless ``R2S_NATIVE=0`` or it does not handle the file."""
    with host_span("PLY read"):
        t = None
        if os.environ.get("R2S_NATIVE", "1") != "0":
            t = read_ply_vertex_table_native(path)
        if t is None:
            t = read_ply_vertex_table(path)
    return t, len(t["x"])


_LOAD_CACHE: dict = {}


def load_gaussian_ply(path: str | Path) -> dict[str, np.ndarray]:
    """Load a 3DGS PLY into raw (pre-activation) splat parameters.

    Keys (all float32): means3D (N, 3), sh_colors (N, 3*(D+1)^2: dc0..2,
    then f_rest row-major), log_scales (N, 3), unnorm_rotations (N, 4),
    logit_opacities (N, 1). Results are cached by (path, mtime); callers
    must not mutate the returned arrays."""
    key = (str(path), Path(path).stat().st_mtime_ns)
    if key in _LOAD_CACHE:
        return _LOAD_CACHE[key]
    t, n = read_ply_table(path)
    means = np.stack([t["x"], t["y"], t["z"]], axis=-1).astype(np.float32)

    n_rest = len([k for k in t if k.startswith("f_rest_")])
    sh = np.zeros((n, 3 + n_rest), dtype=np.float32)
    for i in range(3):
        sh[:, i] = t[f"f_dc_{i}"]
    for i in range(n_rest):
        sh[:, 3 + i] = t[f"f_rest_{i}"]

    n_scale = len([k for k in t if k.startswith("scale_")])
    scales = np.stack([t[f"scale_{i}"] for i in range(n_scale)],
                      axis=-1).astype(np.float32)
    if n_scale == 1:
        scales = np.repeat(scales, 3, axis=-1)
    rots = np.stack([t[f"rot_{i}"] for i in range(4)],
                    axis=-1).astype(np.float32)
    out = {
        "means3D": means,
        "sh_colors": sh,
        "log_scales": scales,
        "unnorm_rotations": rots,
        "logit_opacities": np.asarray(t["opacity"], np.float32)[:, None],
    }
    _LOAD_CACHE[key] = out
    return out


def sh_colors_to_coeffs(sh_colors: np.ndarray) -> np.ndarray:
    """(N, 3*(D+1)^2) flat layout -> (N, (D+1)^2, 3) coefficients: the
    first 3 entries are the DC colour, the rest are stored (3, K) and
    transposed to (K, 3) (the reference's gs_renderer.py:414-418)."""
    n = sh_colors.shape[0]
    dc = sh_colors[:, :3][:, None, :]
    rest = sh_colors[:, 3:].reshape(n, 3, -1).transpose(0, 2, 1)
    return np.concatenate([dc, rest], axis=1).astype(np.float32)


def coeffs_to_sh_colors(coeffs: np.ndarray) -> np.ndarray:
    """Inverse of ``sh_colors_to_coeffs``."""
    n = coeffs.shape[0]
    rest = coeffs[:, 1:, :].transpose(0, 2, 1).reshape(n, -1)
    return np.concatenate([coeffs[:, 0, :], rest], axis=1).astype(np.float32)


def save_gaussian_ply(params: dict[str, np.ndarray], path: str | Path) -> None:
    """Write raw splat params to a binary-little-endian 3DGS PLY."""
    means = np.asarray(params["means3D"], np.float32)
    sh = np.asarray(params["sh_colors"], np.float32)
    if sh.ndim == 3:
        sh = coeffs_to_sh_colors(sh)
    log_scales = np.asarray(params["log_scales"], np.float32)
    rots = np.asarray(params["unnorm_rotations"], np.float32)
    opac = np.asarray(params["logit_opacities"], np.float32).reshape(-1, 1)

    names = (["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2"]
             + [f"f_rest_{i}" for i in range(sh.shape[1] - 3)]
             + ["opacity", "scale_0", "scale_1", "scale_2",
                "rot_0", "rot_1", "rot_2", "rot_3"])
    table = np.empty(means.shape[0],
                     dtype=np.dtype([(nm, "<f4") for nm in names]))
    cols = np.concatenate([means, sh, opac, log_scales, rots], axis=1)
    for i, nm in enumerate(names):
        table[nm] = cols[:, i]

    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {means.shape[0]}\n"
              + "".join(f"property float {nm}\n" for nm in names)
              + "end_header\n")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(table.tobytes())


# antimatter15's .splat record: position, scale, RGBA, quaternion (w x y z)
# mapped to [0, 255]; 32 bytes a splat, little-endian, no header
_SPLAT_RECORD = np.dtype([("pos", "<f4", 3), ("scale", "<f4", 3),
                          ("color", "u1", 4), ("rot", "u1", 4)])


def save_splat(params: dict[str, np.ndarray], path: str | Path,
               center: bool = True, rotate: bool = True) -> None:
    """Export raw splat params to the antimatter15 ``.splat`` byte format
    for web viewers: means centred on their mean and turned from z-up to
    y-up unless asked not to, the DC colour and sigmoid opacity as RGBA
    bytes, the normalised quaternion as bytes."""
    from .sh import C0

    pts = np.asarray(params["means3D"], np.float32).copy()
    sh = np.asarray(params["sh_colors"], np.float32)
    if sh.ndim == 3:
        sh = coeffs_to_sh_colors(sh)
    scales = np.exp(np.asarray(params["log_scales"], np.float32))
    rots = np.asarray(params["unnorm_rotations"], np.float32)
    rots = rots / np.maximum(np.linalg.norm(rots, axis=-1, keepdims=True),
                             1e-12)
    opac = 1.0 / (1.0 + np.exp(-np.asarray(params["logit_opacities"],
                                           np.float32)))
    opac = opac.reshape(-1, 1)

    if center:
        pts -= pts.mean(axis=0)
    if rotate:
        # undo the z-up convention for web viewers (y-up)
        rot_x = np.linalg.inv(np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]],
                                       np.float32))
        pts = pts @ rot_x.T
        w = np.sqrt(np.maximum(1 + rot_x[0, 0] + rot_x[1, 1] + rot_x[2, 2],
                               1e-12)) / 2
        rq = np.array([w,
                       (rot_x[2, 1] - rot_x[1, 2]) / (4 * w),
                       (rot_x[0, 2] - rot_x[2, 0]) / (4 * w),
                       (rot_x[1, 0] - rot_x[0, 1]) / (4 * w)], np.float32)
        w1, x1, y1, z1 = rq
        w2, x2, y2, z2 = rots[:, 0], rots[:, 1], rots[:, 2], rots[:, 3]
        rots = np.stack([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ], axis=-1)

    color = np.concatenate([0.5 + C0 * sh[:, :3], opac], axis=1)
    table = np.empty(pts.shape[0], _SPLAT_RECORD)
    table["pos"] = pts
    table["scale"] = scales
    table["color"] = np.clip(color * 255, 0, 255).astype(np.uint8)
    table["rot"] = np.clip(
        rots / np.maximum(np.linalg.norm(rots, axis=-1, keepdims=True), 1e-12)
        * 128 + 128, 0, 255).astype(np.uint8)

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(table.tobytes())
