"""Decode attention over a contiguous KV cache: one new query token per
sequence against its cache rows ``[0, length)``, GQA native.

Counterpart of ``paddle_tpu/ops/pallas/decode_attention.py`` (the MMHA
analog the generation loop calls once per layer per decode step).
Layouts are the JAX package's: q ``[B, Hq, D]``, ``k_cache`` /
``v_cache`` ``[B, T, Hkv, D]`` (rows ``>= lengths[b]`` ignored),
``lengths`` ``[B]`` int; q head ``h`` reads kv head ``h // G`` with
``G = Hq / Hkv``.  Returns ``[B, Hq, D]`` in q's dtype.  The caches may
be any strided view, e.g. the head-major ``cache_kv[0].transpose(1, 2)``
of Paddle's MMHA cache ``[2, B, H, T_max, D]`` (the layout the Pallas
kernel itself works in, ``decode_attention.py:101-103``): the kernel
reads it in place through its head stride.

Two versions and no third:

* the plain PyTorch version (:func:`decode_attention_ref`) with the TPU
  kernel's arithmetic, not the JAX reference's: fp32 scores, masked
  scores set to ``NEG_INF`` (finite), an online softmax over blocks of
  ``BLOCK_T`` = 512 cache rows (the Pallas kernel's ``block_t``), ``p``
  rounded to v's dtype before ``p @ v`` (the JAX reference keeps ``p`` in
  fp32), and ``acc / max(l, 1e-30)``.  It runs for tensors on the CPU.
  Like the Pallas kernel it takes a q whose dtype differs from the
  cache's (fp32 q over a bf16 cache, as MMHA gives after
  ``qkv_out_scale``): scores in fp32, ``p`` rounded to v's dtype.
* the hand-written CUDA kernel (:mod:`.cuda.decode_attention`) for
  tensors on a CUDA device: it launches or raises (a q and cache of two
  dtypes, or a float16 cache, raise ``NotImplementedError``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .cuda import decode_attention as _cuda

__all__ = ["NEG_INF", "BLOCK_T", "decode_attention", "decode_attention_ref"]

NEG_INF = -1e30
BLOCK_T = 512


def _check(q, k_cache, v_cache, lengths):
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode attention takes q [B, Hq, D] and k/v "
                         f"caches [B, T, Hkv, D]; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} disagree on B or D")
    if Hq % k_cache.shape[2]:
        raise ValueError(f"q heads ({Hq}) must be a multiple of kv heads "
                         f"({k_cache.shape[2]})")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B] = [{B}], got "
                         f"{tuple(lengths.shape)}")


def decode_attention_ref(q, k_cache, v_cache, lengths,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Plain version (the Pallas kernel's rounding points, see the module
    docstring)."""
    B, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D).float()
    kt = k_cache.float().permute(0, 2, 3, 1)                # [B, Hkv, D, T]
    vt = v_cache.transpose(1, 2)                            # [B, Hkv, T, D]
    scores = (qg @ kt) * s                                  # [B, Hkv, G, T]
    keep = (torch.arange(T, device=q.device)[None, :]
            < lengths.to(q.device).long()[:, None])[:, None, None, :]
    scores = torch.where(keep, scores, NEG_INF)
    m = torch.full((B, Hkv, G, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, D), device=q.device)
    for t0 in range(0, T, BLOCK_T):
        blk = scores[..., t0:t0 + BLOCK_T]
        m_new = torch.maximum(m, blk.amax(-1, keepdim=True))
        p = torch.exp(blk - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v_cache.dtype).float() \
            @ vt[:, :, t0:t0 + BLOCK_T].float()
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Masked decode attention (forward only): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    _check(q, k_cache, v_cache, lengths)
    s = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    if q.device.type == "cuda":
        return _cuda.decode_attention_cuda(q, k_cache, v_cache, lengths, s)
    if q.device.type != "cpu":
        raise ValueError(f"decode attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    return decode_attention_ref(q, k_cache, v_cache, lengths, s)
