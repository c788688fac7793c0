"""Fused elementwise ops: ``swiglu``.

Counterpart of ``paddle_tpu/ops/pallas/fused.py`` for SwiGLU (its other
three functions, ``fused_softmax_mask``, ``fused_bias_act`` and
``fused_dropout_add``, are ROADMAP queue 1 item 19).

The forward has two versions and no third:

* the plain PyTorch version (:func:`swiglu_ref`) with the Pallas kernel's
  arithmetic: ``silu(x) * y = x * sigmoid(x) * y`` in fp32 and one
  rounding to x's dtype.  It runs for tensors on the CPU.
* the hand-written CUDA kernel (:mod:`.cuda.fused`) for tensors on a
  CUDA device: it launches or raises, with no fallback.

The backward is the JAX ``_swiglu_bwd`` (``fused.py:68-77``) in torch
ops.
"""

from __future__ import annotations

import torch

from .cuda import fused as _cuda

__all__ = ["swiglu", "swiglu_ref", "swiglu_bwd"]


def swiglu_ref(x, y):
    """Plain forward: ``x * sigmoid(x) * y`` in fp32, in x's dtype."""
    xf = x.float()
    return (xf * torch.sigmoid(xf) * y.float()).to(x.dtype)


def swiglu_bwd(x, y, g):
    """JAX ``_swiglu_bwd``: ``(dx in x's dtype, dy in y's dtype)``."""
    x32, g32 = x.float(), g.float()
    sig = torch.sigmoid(x32)
    dsilu = sig * (1 + x32 * (1 - sig))
    return ((g32 * y.float() * dsilu).to(x.dtype),
            (g32 * (x32 * sig)).to(y.dtype))


class _SwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        if x.device.type not in ("cuda", "cpu"):
            raise ValueError(f"swiglu runs on CUDA or CPU tensors, got "
                             f"{x.device}")
        fwd = _cuda.swiglu_fwd_cuda if x.device.type == "cuda" \
            else swiglu_ref
        ctx.save_for_backward(x, y)
        return fwd(x, y)

    @staticmethod
    def backward(ctx, g):
        return swiglu_bwd(*ctx.saved_tensors, g)


def swiglu(x, y) -> torch.Tensor:
    """``silu(x) * y``, x and y of one shape; differentiable in both."""
    if x.shape != y.shape:
        raise ValueError(f"swiglu takes x and y of one shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    return _SwiGLU.apply(x, y)
