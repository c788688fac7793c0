"""Fused rotary position embedding (rotate-half RoPE): ``fused_rope``.

Counterpart of ``paddle_tpu/ops/pallas/rope.py``.  Layout ``[batch, seq,
heads, head_dim]``; ``rotate_half(x) = [-x[..., D/2:], x[..., :D/2]]``.

The rotation has two versions and no third:

* the plain PyTorch version (:func:`rope_ref`) with the Pallas kernel's
  arithmetic: x, cos and sin upcast to fp32, ``sin * sign`` first, then
  ``x * cos + rotate_half(x) * sin`` in fp32 and one rounding to x's
  dtype.  It runs for tensors on the CPU.
* the hand-written CUDA kernel (:mod:`.cuda.rope`) for tensors on a CUDA
  device: it launches or raises, with no fallback.  It reads x in place
  (the JAX package transposes to ``[B*H, S, D]`` and back around its
  call) and takes any even head_dim.

The VJP is the inverse rotation, ``R(theta)^T = R(-theta)``: the same
kernel with ``sign = -1`` on the cotangent (``rope.py:67-82``); no
activation is saved.  One launch per tensor, as in JAX: ``fused_rope(q,
k)`` launches twice forward and twice backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cuda import rope as _cuda

__all__ = ["rope_cos_sin", "rope_ref", "fused_rope"]


def rope_cos_sin(seq_len: int, head_dim: int, base: float = 10000.0,
                 dtype=torch.float32, position_ids=None, device=None):
    """``(cos, sin)`` tables ``[S, D]``: ``inv = 1 / base^(2i / D)`` in
    fp32, angles ``pos x inv`` repeated over both halves; positions
    ``0 .. S-1``, or ``position_ids`` (flattened, as ``jnp.outer`` does;
    S of them)."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    if position_ids is None:
        pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    else:
        pos = torch.as_tensor(position_ids, device=device).reshape(-1) \
            .to(torch.float32)
        if pos.numel() != seq_len:
            raise ValueError(f"position_ids must hold {seq_len} positions "
                             f"(one per token), got {pos.numel()}")
    freqs = torch.outer(pos, inv)
    emb = torch.cat([freqs, freqs], -1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rope_ref(x, cos, sin, sign: float = 1.0):
    """Plain rotation of ``x [B, S, H, D]`` by ``[S, D]`` tables, in x's
    dtype."""
    xf = x.float()
    c = cos.float()[None, :, None, :]
    s = (sin.float() * sign)[None, :, None, :]
    d2 = x.shape[-1] // 2
    rot = torch.cat([-xf[..., d2:], xf[..., :d2]], -1)
    return (xf * c + rot * s).to(x.dtype)


def _apply(x, cos, sin, sign):
    if x.device.type == "cuda":
        return _cuda.rope_fwd_cuda(x, cos, sin, sign)
    if x.device.type != "cpu":
        raise ValueError(f"rope runs on CUDA or CPU tensors, got {x.device}")
    return rope_ref(x, cos, sin, sign)


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _apply(x, cos, sin, 1.0)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return _apply(g, cos, sin, -1.0), None, None


def fused_rope(q, k=None, v=None, sin=None, cos=None, position_ids=None,
               use_neox_rotary_style: bool = True, base: float = 10000.0
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                          Optional[torch.Tensor]]:
    """RoPE on q (and k); v passes through untouched.  A caller's cos /
    sin are reshaped to ``[S, D]``; without them the fp32 tables of
    :func:`rope_cos_sin` (from ``position_ids`` when given) are built.
    Differentiable in q and k.  ``use_neox_rotary_style`` is accepted and
    ignored: the JAX op always rotates halves (``rope.py:85-99`` never
    reads it)."""
    if q.ndim != 4:
        raise ValueError(f"fused_rope takes [B, S, H, D] tensors, got "
                         f"{tuple(q.shape)}")
    S, D = q.shape[1], q.shape[-1]
    if cos is None or sin is None:
        cos, sin = rope_cos_sin(S, D, base, torch.float32, position_ids,
                                q.device)
    else:
        cos, sin = cos.reshape(S, D), sin.reshape(S, D)
    out_q = _Rope.apply(q, cos, sin)
    out_k = _Rope.apply(k, cos, sin) if k is not None else None
    return out_q, out_k, v
