"""Fused elementwise and row ops: ``swiglu``, ``fused_softmax_mask``,
``fused_bias_act`` and ``fused_dropout_add``.

Counterpart of ``paddle_tpu/ops/pallas/fused.py``.  Each forward has two
versions and no third:

* the plain PyTorch version (:func:`swiglu_ref`, :func:`softmax_mask_ref`,
  :func:`bias_act_ref`, :func:`dropout_add_ref`) with the Pallas kernel's
  arithmetic: inputs upcast to fp32, the function in fp32 and one
  rounding to x's dtype.  It runs for tensors on the CPU.
* the hand-written CUDA kernel (:mod:`.cuda.fused`) for tensors on a CUDA
  device: it launches or raises, with no fallback.

SwiGLU's backward is the JAX ``_swiglu_bwd`` (``fused.py:68-77``) in torch
ops.  The other three have no backward in the JAX package: their
``pallas_call``s carry no custom VJP, and ``jax.grad`` through them fails
("Linearization failed").  The port adds no gradient the reference lacks:
their ``backward`` raises ``NotImplementedError`` (ROADMAP queue 3,
"No backward through kernels 17, 18, 19").

Dropout bits come from Threefry-2x32 (:mod:`.threefry`) keyed by a seed
drawn from the caller's ``torch.Generator``, never from a global RNG; the
TPU kernel's bits come from the TPU's PRNG, so the masks agree with the
JAX package's in distribution, and the kernel's output equals its plain
version's bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import threefry
from .cuda import fused as _cuda

__all__ = ["swiglu", "swiglu_ref", "swiglu_bwd", "ACT_METHODS",
           "fused_softmax_mask", "softmax_mask_ref", "fused_bias_act",
           "bias_act_ref", "fused_dropout_add", "dropout_add_ref"]

#: the activations of ``fused_bias_act`` (the JAX ``_ACTS``, ``fused.py:116``)
ACT_METHODS = ("gelu", "relu", "silu", "swiglu", "tanh", "sigmoid")


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


def _on_cuda(t, what) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got "
                         f"{t.device}")
    return t.device.type == "cuda"


def _no_grad_error(name):
    return NotImplementedError(
        f"{name} has no gradient: the reference has none there either (its "
        f"pallas_call in paddle_tpu/ops/pallas/fused.py carries no custom "
        f"VJP, so jax.grad through it fails); ROADMAP queue 3")


class _ForwardOnly(torch.autograd.Function):
    """``fn(*args)`` forward; a backward that raises, as ``jax.grad``
    through the JAX kernel fails."""

    @staticmethod
    def forward(ctx, name, fn, *args):
        ctx.name = name
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise _no_grad_error(ctx.name)


def softmax_mask_ref(x, mask):
    """Plain forward: ``e / sum(e)``, ``e = exp(x + mask - max)`` in fp32
    over the last axis, in x's dtype."""
    v = x.float() + mask.float()
    e = torch.exp(v - v.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(x.dtype)


def fused_softmax_mask(x, mask) -> torch.Tensor:
    """``softmax(x + mask)`` over the last axis, mask broadcastable to x
    (read in place by the kernel).  A row whose mask is all -inf gives NaN,
    as in JAX.  No gradient."""
    if torch.broadcast_shapes(mask.shape, x.shape) != x.shape:
        raise ValueError(f"fused_softmax_mask: mask {tuple(mask.shape)} does "
                         f"not broadcast to x {tuple(x.shape)}")
    fn = _cuda.softmax_mask_fwd_cuda if _on_cuda(x, "fused_softmax_mask") \
        else softmax_mask_ref
    return _ForwardOnly.apply("fused_softmax_mask", fn, x, mask)


_SQRT_2_OVER_PI = 0.7978845608028654

_ACTS = {
    # jax.nn.gelu(approximate=True)
    "gelu": lambda v: v * (0.5 * (1.0 + torch.tanh(
        _SQRT_2_OVER_PI * (v + 0.044715 * (v * v * v))))),
    "relu": torch.relu,
    "silu": lambda v: v * torch.sigmoid(v),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def bias_act_ref(x, bias, act: str = "gelu"):
    """Plain forward: ``act(x + bias)`` in fp32, in x's dtype."""
    return _ACTS[act](x.float() + bias.float()).to(x.dtype)


def fused_bias_act(x, bias, act_method: str = "gelu") -> torch.Tensor:
    """``act(x + bias)``, act one of :data:`ACT_METHODS` (gelu is the tanh
    approximation).  ``"swiglu"``: ``x + bias`` with dtype promotion (a
    bf16 x and an fp32 bias give fp32), its halves through :func:`swiglu`
    (differentiable); the others have no gradient."""
    if act_method not in ACT_METHODS:
        raise ValueError(f"fused_bias_act: unknown act_method {act_method!r}"
                         f" (one of {', '.join(ACT_METHODS)})")
    if act_method == "swiglu":
        h = x.shape[-1] // 2
        xb = x + bias
        return swiglu(xb[..., :h], xb[..., h:])
    fn = _cuda.bias_act_fwd_cuda if _on_cuda(x, "fused_bias_act") \
        else bias_act_ref
    return _ForwardOnly.apply("fused_bias_act", fn, x, bias, act_method)


def dropout_add_ref(x, y, p: float, drop: bool, seed=None):
    """Plain forward: ``dropout(x) + y`` in fp32, in x's dtype, with the
    kernel's Threefry keep mask of ``seed`` (an int or a one-element
    tensor) and its fp32 scale."""
    xf = x.float()
    if drop:
        keep = threefry.keep_mask(int(seed), x.shape, p, x.device)
        xf = torch.where(keep, xf * _cuda.dropout_scale(p), 0.0)
    return (xf + y.float()).to(x.dtype)


def fused_dropout_add(x, y, p: float = 0.5, training: bool = False,
                      seed=None, mode: str = "upscale_in_train",
                      generator: Optional[torch.Generator] = None):
    """``dropout(x) + y`` in one pass.  With ``training`` and ``p > 0``, x
    is kept where its Threefry bits clear p and scaled by ``1 / (1 - p)``;
    the seed is ``seed`` or, when None, drawn from ``generator`` (the
    default generator of x's device when None) as a one-element int64
    tensor on x's device.  Otherwise the kernel still runs, as ``x + y``.
    ``mode`` is accepted and ignored, as in the JAX kernel: a
    ``downscale_in_infer`` caller gets ``upscale_in_train``.  No
    gradient."""
    if y.shape != x.shape:
        raise ValueError(f"fused_dropout_add: y {tuple(y.shape)} must have "
                         f"x's shape {tuple(x.shape)}")
    drop = bool(training) and p > 0.0
    seed_t = None
    if drop:
        seed_t = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                               device=x.device, dtype=torch.int64) \
            if seed is None else torch.tensor([int(seed)], dtype=torch.int64,
                                              device=x.device)
    fn = _cuda.dropout_add_fwd_cuda if _on_cuda(x, "fused_dropout_add") \
        else dropout_add_ref
    return _ForwardOnly.apply("fused_dropout_add", fn, x, y, float(p), drop,
                              seed_t)
