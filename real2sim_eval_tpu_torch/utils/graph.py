"""Replay a fixed-shape function as one captured CUDA graph.

A stage that runs many small kernels at a fixed shape spends its time on
the host, which enqueues one PyTorch operation at a time. ``Graphed(fn)``
is a callable that, for each input signature (shapes, dtypes,
device), captures ``fn`` once into a ``torch.cuda.CUDAGraph`` and later
replays it: the inputs are copied into the graph's static input tensors,
the graph is replayed, and a clone of its static output is returned, so a
result the caller keeps never aliases a buffer that the next replay
overwrites.

``fn`` takes and returns tensors, and runs no operation that synchronises
the host or needs a size the data decides. Tensors it reads other than
its arguments (cached constants) must outlive the graph. A capture that
fails raises: there is no fallback to the eager function.
"""

from __future__ import annotations

from typing import Callable

import torch

from .profiling import count, host_span


def _record(fn: Callable, static_in: tuple):
    """Capture ``fn(*static_in)`` into a CUDA graph on the inputs' device.
    Returns (replay, static output). One warm-up call runs first on a side
    stream, as PyTorch's capture requires (library handles, workspaces and
    cached constants are made there, outside the graph)."""
    device = static_in[0].device
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*static_in)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*static_in)
    return graph.replay, out


def signature(args: tuple) -> tuple:
    """The key a graph is captured under: each input's shape, dtype and
    device."""
    return tuple((tuple(a.shape), a.dtype, a.device) for a in args)


class Graphed:
    """``fn`` captured once per input signature and replayed after.

    ``captures`` counts the captures made, ``replays`` the replays."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._graphs: dict = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        key = signature(args)
        entry = self._graphs.get(key)
        if entry is None:
            with host_span("graph capture"):
                static_in = tuple(a.clone() for a in args)
                replay, out = _record(self.fn, static_in)
            entry = self._graphs[key] = (static_in, replay, out)
            self.captures += 1
            count("graph_captures")
            count(f"graph captures of {[tuple(a.shape) for a in args]}")
        static_in, replay, out = entry
        for s, a in zip(static_in, args):
            s.copy_(a)
        replay()
        self.replays += 1
        count("graph_replays")
        return out.clone()
