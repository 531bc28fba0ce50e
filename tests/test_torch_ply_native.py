"""The port's C++ PLY reader (``csrc/host/ply_loader.cpp`` through
``utils/ply.py``) against its numpy reader and against the JAX package's
``_read_vertex_table_native``, bitwise, on seeded binary PLYs with and
without normals and ``f_rest``, with an f64 property and with an element
before the vertices; ``R2S_NATIVE=0`` selects the numpy reader; a file
the C++ reader does not handle (ASCII) goes to the numpy reader; a
reader that does not build raises with the compiler's message."""

import numpy as np
import pytest


def write_ply(path, n, normals: bool, n_rest: int, seed: int,
              f64: bool = False, face_first: bool = False):
    rng = np.random.default_rng(seed)
    names = (["x", "y", "z"] + (["nx", "ny", "nz"] if normals else [])
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(n_rest)]
             + ["opacity"] + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    types = {nm: "<f4" for nm in names}
    if f64:
        types["opacity"] = "<f8"
    table = np.empty(n, np.dtype([(nm, types[nm]) for nm in names]))
    for nm in names:
        table[nm] = rng.normal(size=n)
    head = "ply\nformat binary_little_endian 1.0\ncomment seeded\n"
    body = b""
    if face_first:
        head += "element camera 2\nproperty float a\nproperty uchar b\n"
        body = rng.integers(0, 255, 2 * 5, dtype=np.uint8).tobytes()
    head += f"element vertex {n}\n" + "".join(
        f"property {'double' if types[nm] == '<f8' else 'float'} {nm}\n"
        for nm in names) + "end_header\n"
    with open(path, "wb") as f:
        f.write(head.encode("ascii") + body + table.tobytes())
    return names


def bits(t: dict) -> dict:
    return {k: np.ascontiguousarray(v, np.float32).view(np.uint32)
            for k, v in t.items()}


CASES = {"plain": dict(normals=False, n_rest=0),
         "normals": dict(normals=True, n_rest=0),
         "f_rest": dict(normals=False, n_rest=45),
         "normals_f_rest": dict(normals=True, n_rest=45),
         "f64_opacity": dict(normals=False, n_rest=9, f64=True),
         "element_before": dict(normals=True, n_rest=0, face_first=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_native_reader_bitwise(tmp_path, case, monkeypatch):
    from real2sim_eval_tpu.utils import ply as jply
    from real2sim_eval_tpu_torch.utils import ply

    path = tmp_path / "s.ply"
    names = write_ply(path, 1537, seed=len(case), **CASES[case])
    monkeypatch.delenv("R2S_NATIVE", raising=False)
    native, n = ply.read_ply_table(path)
    assert n == 1537 and list(native) == names
    assert all(v.dtype == np.float32 for v in native.values())
    plain = ply.read_ply_vertex_table(path)
    jax_native = jply._read_vertex_table_native(path)
    assert list(plain) == list(jax_native) == names
    nb = bits(native)
    for other in (plain, jax_native):
        ob = bits(other)
        for k in names:
            np.testing.assert_array_equal(nb[k], ob[k], err_msg=k)

    calls = []
    monkeypatch.setattr(ply, "read_ply_vertex_table_native",
                        lambda p: calls.append(p))
    monkeypatch.setenv("R2S_NATIVE", "0")
    t, _ = ply.read_ply_table(path)
    assert not calls
    assert all(np.array_equal(t[k], plain[k]) for k in names)


def test_unhandled_files_go_to_numpy(tmp_path, monkeypatch):
    from real2sim_eval_tpu_torch.utils import ply

    monkeypatch.delenv("R2S_NATIVE", raising=False)
    path = tmp_path / "a.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 2\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "end_header\n1 2 3\n4 5 6\n")
    assert ply.read_ply_vertex_table_native(path) is None
    t, n = ply.read_ply_table(path)
    assert n == 2 and t["z"].tolist() == [3.0, 6.0]


def test_a_reader_that_does_not_build_raises(tmp_path, monkeypatch):
    from real2sim_eval_tpu_torch.utils import ply

    src = tmp_path / "broken.cpp"
    src.write_text("extern \"C\" int ply_probe( { this is not C++ }\n")
    monkeypatch.setattr(ply, "_NATIVE_SRC", src)
    monkeypatch.setattr(ply, "_NATIVE_SO", tmp_path / "lib.so")
    monkeypatch.setattr(ply, "_NATIVE", [])
    monkeypatch.delenv("R2S_NATIVE", raising=False)
    write_ply(tmp_path / "s.ply", 4, normals=False, n_rest=0, seed=0)
    with pytest.raises(RuntimeError, match="error"):
        ply.read_ply_table(tmp_path / "s.ply")
    assert not (tmp_path / "lib.so").exists()
