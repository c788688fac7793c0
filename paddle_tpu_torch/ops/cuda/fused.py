"""SwiGLU on the card: ``swiglu_fwd`` (``kernels/csrc/swiglu.cu``).

The wrapper takes two CUDA tensors of one shape and one dtype (float32 or
bfloat16), makes them contiguous, allocates the output and launches one
kernel on the current stream; it raises on anything else.
"""

from __future__ import annotations

import torch

from ...kernels import build
from . import layer

__all__ = ["swiglu_fwd_cuda"]


def swiglu_fwd_cuda(x, y):
    """``silu(x) * y`` in x's shape and dtype."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("swiglu: the kernel needs CUDA tensors")
    if not isinstance(y, torch.Tensor) or y.device != x.device or \
            y.shape != x.shape or y.dtype != x.dtype:
        raise ValueError(f"swiglu: y must match x ({tuple(x.shape)}, "
                         f"{x.dtype}, {x.device})")
    code = layer.dtype_code(x.dtype)
    if x.numel() == 0:
        raise ValueError("swiglu: the kernel needs at least one element")
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty_like(x)
    build.check(build.library().pt_swiglu_fwd(
        code, x.numel(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
        layer.stream_handle()), "pt_swiglu_fwd")
    return out
