"""The reference runs no CUDA kernel: every caller takes the plain
PyTorch version, so nothing here is ever loaded."""

LAUNCHES: dict = {}


def load():
    raise RuntimeError("the benchmark's reference has no CUDA kernels")
