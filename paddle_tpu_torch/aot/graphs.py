"""Captured CUDA graphs: the port's counterpart of a jitted program.

The JAX engine runs each fixed-geometry step as one compiled XLA program
(``jax.jit``).  On the card the counterpart is a CUDA graph: the step's
launches (the layer chain's kernels, the torch ops around them) are
captured once at fixed shapes and replayed with one launch from the host.
A :class:`CapturedProgram` owns the program's static input buffers (on
the device, outside the graph's memory pool) and pinned host buffers to
stage their values in, runs the program's function once on a side stream
(a kernel's first call sets shared-memory attributes and queries cluster
occupancy, which a capture may not), captures one call into a memory pool
that the caller may share between programs that never run at the same
time, and replays it, returning the captured call's outputs (the same
tensors each replay: read them before the next replay of any program of
the pool).

Nothing falls back: a capture or a replay that fails raises
:class:`GraphCaptureError` naming the program.  Programs exist on CUDA
only; on the CPU callers run the plain functions.

Launch counts: the library counts a launch when it returns
``cudaSuccess``, which a launch under capture does without running.  The
counters' difference over the capture is the program's launches a
replay; ``ops.cuda.layer.TALLY`` subtracts it once and adds it once per
replay, so ``layer.launch_counts()`` counts what ran.  The warm-up call
ran, and stays counted.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from ..ops.cuda import layer

__all__ = ["CapturedProgram", "GraphCaptureError"]


class GraphCaptureError(RuntimeError):
    """A program could not be captured or replayed as a CUDA graph."""


class CapturedProgram:
    """``fn(**inputs)`` captured as a CUDA graph at the shapes and dtypes
    of ``inputs`` (CUDA tensors; their values are the state the warm-up
    and the capture run on, e.g. a block table of -1 so that no live
    page is written).  Calling it copies new input values into the static
    buffers (numpy arrays and CPU tensors through pinned staging, CUDA
    tensors device to device), replays, and returns the outputs."""

    def __init__(self, name: str, fn: Callable,
                 inputs: Dict[str, torch.Tensor], *, pool=None):
        self.name = name
        self.static = {k: v.detach().clone() for k, v in inputs.items()}
        self.staging = {k: torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=True)
                        for k, v in self.static.items()}
        self._staged = torch.cuda.Event()
        self.replays = 0
        t0 = time.perf_counter()
        try:
            before = layer.raw_counts()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.no_grad(), torch.cuda.stream(side):
                fn(**self.static)
            torch.cuda.current_stream().wait_stream(side)
            warm = layer.raw_counts()
            self.graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), torch.cuda.graph(self.graph, pool=pool):
                self.outputs = fn(**self.static)
            after = layer.raw_counts()
            torch.cuda.synchronize()
        except Exception as e:
            raise GraphCaptureError(
                f"{name}: CUDA graph capture failed: {type(e).__name__}: "
                f"{e}") from e
        self.warmup_launches = {k: n - before[k] for k, n in warm.items()
                                if n != before[k]}
        self.launches = layer.TALLY.captured(warm, after)
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _stage(self, name: str, value) -> None:
        dst = self.static[name]
        if isinstance(value, torch.Tensor) and value.is_cuda:
            if tuple(value.shape) != tuple(dst.shape):
                raise ValueError(f"{self.name}: {name} has shape "
                                 f"{tuple(value.shape)}, the graph takes "
                                 f"{tuple(dst.shape)}")
            dst.copy_(value)
            return
        st = self.staging[name]
        if isinstance(value, torch.Tensor):
            st.copy_(value)
        else:
            arr = np.asarray(value)
            if arr.shape != tuple(st.shape):
                raise ValueError(f"{self.name}: {name} has shape "
                                 f"{arr.shape}, the graph takes "
                                 f"{tuple(st.shape)}")
            st.numpy()[...] = arr
        dst.copy_(st, non_blocking=True)

    def __call__(self, **values):
        # the previous call's staging copies must have left the pinned
        # buffers before they are written again
        self._staged.synchronize()
        for k, v in values.items():
            self._stage(k, v)
        self._staged.record()
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise GraphCaptureError(
                f"{self.name}: CUDA graph replay failed: {e}") from e
        self.replays += 1
        layer.TALLY.replayed(self.launches)
        return self.outputs

    def stats(self) -> Dict[str, object]:
        """Replays, capture ms (warm-up included), the library launches a
        replay makes and those of the warm-up call."""
        return {"replays": self.replays, "capture_ms": self.capture_ms,
                "launches": dict(self.launches),
                "warmup_launches": dict(self.warmup_launches)}

