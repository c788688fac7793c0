"""Rotate-half RoPE on the card: ``rope_fwd`` (``kernels/csrc/
fused_ops.cu``).

The wrapper takes one ``[B, S, H, D]`` CUDA tensor (float32 or bfloat16,
any even D) and the ``[S, D]`` cos / sin tables, allocates the output and
launches one kernel on the current stream.  x is made contiguous (a no-op
for the layers' tensors) and read in place with the token stride
``H * D``; the tables are passed as fp32 (upcasting a bf16 one is exact,
and the kernel computes in fp32).  It raises on anything else.
"""

from __future__ import annotations

import torch

from ...kernels import build
from . import layer

__all__ = ["rope_fwd_cuda"]


def rope_fwd_cuda(x, cos, sin, sign: float = 1.0):
    """``x * cos + rotate_half(x) * (sin * sign)`` in x's shape and dtype;
    ``sign`` -1 applies the inverse rotation (the VJP)."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("rope: the kernel needs CUDA tensors")
    code = layer.dtype_code(x.dtype)
    if x.ndim != 4 or x.numel() == 0:
        raise ValueError(f"rope: x must be a non-empty [B, S, H, D] tensor, "
                         f"got {tuple(x.shape)}")
    B, S, H, D = x.shape
    if D % 2:
        raise ValueError(f"rope: head_dim must be even, got {D}")
    tables = []
    for name, t in (("cos", cos), ("sin", sin)):
        if not isinstance(t, torch.Tensor) or t.device != x.device or \
                tuple(t.shape) != (S, D):
            raise ValueError(f"rope: {name} must be a [{S}, {D}] tensor on "
                             f"{x.device}")
        layer.dtype_code(t.dtype)
        tables.append(t.to(torch.float32).contiguous())
    x = x.contiguous()
    out = torch.empty_like(x)
    build.check(build.library().pt_rope_fwd(
        code, B * S * H, S, H, D, float(sign), x.data_ptr(),
        tables[0].data_ptr(), tables[1].data_ptr(), out.data_ptr(),
        layer.stream_handle()), "pt_rope_fwd")
    return out
