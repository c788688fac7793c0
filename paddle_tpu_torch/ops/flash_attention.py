"""Flash attention for training: forward, recompute backward, autograd.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``.  Layouts are
the JAX package's: q ``[B, Sq, Hq, D]``, k/v ``[B, Sk, Hkv, D]`` with
``Hq % Hkv == 0`` (GQA: q head ``h`` reads kv head ``h // G``), out in q's
dtype, lse fp32 ``[B, Hq, Sq, 1]``; optional ``segment_ids`` /
``kv_segment_ids`` ``[B, S]`` int (tokens attend within equal ids) and an
additive ``bias`` ``[B|1, Hq|1, Sq, Sk]``.

Each pass has two versions and no third:

* the plain PyTorch version (:func:`flash_fwd_ref`, :func:`flash_bwd_ref`)
  with the TPU kernels' arithmetic: fp32 logits, masked logits set to
  ``NEG_INF`` (finite), causal top-left aligned (``q_pos >= k_pos``),
  ``p`` rounded to v's dtype before ``p @ v``, ``l`` clamped to 1e-30 and
  ``lse = m + log(l)``; in the backward ``delta = rowsum(out * do)`` in
  fp32, ``p = exp(s - lse)``, ``ds = p (dp - delta) scale`` rounded to the
  input dtype before the dq and dk products, ``p`` rounded to do's dtype
  before the dv product.  It runs for tensors on the CPU.
* the hand-written CUDA kernels (:mod:`.cuda.flash_attention`) for tensors
  on a CUDA device: they launch or raise, with no fallback.

A row whose every key is masked is left out of the contract: with a
finite ``NEG_INF`` the TPU kernel averages v over the keys of the blocks it
visited, which depends on its block size, and so do the port's versions.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .cuda import flash_attention as _cuda

__all__ = ["NEG_INF", "flash_attention", "flash_attention_with_lse",
           "flash_attention_bwd", "flash_fwd_ref", "flash_bwd_ref",
           "flash_delta"]

NEG_INF = -1e30


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"{t.device}")
    return t.device.type == "cuda"


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention takes q [B, Sq, Hq, D] and k, v "
                         f"[B, Sk, Hkv, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads ({q.shape[2]}) must be a multiple of kv "
                         f"heads ({k.shape[2]}) for GQA")


def _per_q_head(t, G):
    """[B, Sk, Hkv, D] -> fp32 [B, Hq, Sk, D] (kv head h // G per q head)."""
    t = t.float().transpose(1, 2)
    return t if G == 1 else t.repeat_interleave(G, dim=1)


def _logits(q, k, scale, causal, seg_q, seg_k, bias):
    """fp32 logits [B, Hq, Sq, Sk] with the kernels' masks."""
    G = q.shape[2] // k.shape[2]
    s = (q.float().transpose(1, 2) @ _per_q_head(k, G).transpose(-1, -2)) \
        * scale
    if bias is not None:
        s = s + bias.float()
    Sq, Sk = s.shape[-2:]
    if causal:
        keep = (torch.arange(Sq, device=s.device)[:, None]
                >= torch.arange(Sk, device=s.device)[None, :])
        s = torch.where(keep, s, NEG_INF)
    if seg_q is not None:
        same = seg_q[:, :, None] == seg_k[:, None, :]          # [B, Sq, Sk]
        s = torch.where(same[:, None], s, NEG_INF)
    return s


def flash_delta(out, do, dlse=None):
    """``rowsum(out * do)`` in fp32 as ``[B, Hq, Sq, 1]``, less the lse
    cotangent ``dlse`` where one is given (``d lse / d s = p``, so it
    enters ``ds = p (dp - delta)`` with the opposite sign)."""
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2)[..., None]
    return delta if dlse is None else delta - dlse.float()


def flash_fwd_ref(q, k, v, scale, causal, seg_q=None, seg_k=None,
                  bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: ``(out [B, Sq, Hq, D], lse [B, Hq, Sq, 1] fp32)``."""
    G = q.shape[2] // k.shape[2]
    s = _logits(q, k, scale, causal, seg_q, seg_k, bias)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = p.to(v.dtype).float() @ _per_q_head(v, G)
    out = (acc / l).to(q.dtype).transpose(1, 2).contiguous()
    return out, m + torch.log(l)


def flash_bwd_ref(q, k, v, out, lse, do, scale, causal, seg_q=None,
                  seg_k=None, bias=None, dlse=None):
    """Plain recompute backward: ``(dq, dk, dv)`` in the inputs' layouts
    and dtypes; dk/dv sum over the G q heads of each kv head in fp32."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    p = torch.exp(_logits(q, k, scale, causal, seg_q, seg_k, bias) - lse)
    dof = do.float().transpose(1, 2)                          # [B, Hq, Sq, D]
    dp = dof @ _per_q_head(v, G).transpose(-1, -2)
    ds = p * (dp - flash_delta(out, do, dlse)) * scale
    dq = ds.to(k.dtype).float() @ _per_q_head(k, G)
    dk = ds.to(q.dtype).float().transpose(-1, -2) @ q.float().transpose(1, 2)
    dv = p.to(do.dtype).float().transpose(-1, -2) @ dof

    def fold(t, dtype):                   # [B, Hq, Sk, D] -> [B, Sk, Hkv, D]
        return t.reshape(B, Hkv, G, Sk, D).sum(2).to(dtype).transpose(1, 2) \
            .contiguous()
    return (dq.to(q.dtype).transpose(1, 2).contiguous(), fold(dk, k.dtype),
            fold(dv, v.dtype))


def _fwd(q, k, v, scale, causal, seg_q, seg_k, bias):
    if _on_cuda(q):
        return _cuda.flash_fwd_cuda(q, k, v, scale, causal, seg_q, seg_k,
                                    bias)
    return flash_fwd_ref(q, k, v, scale, causal, seg_q, seg_k, bias)


def _bwd(q, k, v, out, lse, do, scale, causal, seg_q, seg_k, bias,
         dlse=None):
    if _on_cuda(q):
        return _cuda.flash_bwd_cuda(q, k, v, out, lse, do, scale, causal,
                                    seg_q, seg_k, bias, dlse)
    return flash_bwd_ref(q, k, v, out, lse, do, scale, causal, seg_q, seg_k,
                         bias, dlse)


def _resolve(q, k, v, scale, segment_ids, kv_segment_ids):
    _check(q, k, v)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    return float(s), kv_segment_ids


class _Flash(torch.autograd.Function):
    """Differentiable in q, k and v only: segment ids and bias get no
    gradient (the JAX package's ``_flash_bwd_rule`` returns zeros for
    them).  Saves q, k, v, out and lse for the backward (plus the segment
    ids and bias it was given); under activation checkpointing the forward
    runs again in the backward pass."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, seg_q, seg_k, bias, with_lse):
        out, lse = _fwd(q, k, v, scale, causal, seg_q, seg_k, bias)
        ctx.save_for_backward(q, k, v, out, lse, seg_q, seg_k, bias)
        ctx.scale, ctx.causal = scale, causal
        if with_lse:
            return out, lse
        return out

    @staticmethod
    def backward(ctx, do, dlse=None):
        q, k, v, out, lse, seg_q, seg_k, bias = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        dq, dk, dv = _bwd(q, k, v, out, lse, do, ctx.scale, ctx.causal,
                          seg_q, seg_k, bias, dlse)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, scale: Optional[float] = None,
                    causal: bool = False, segment_ids=None,
                    kv_segment_ids=None, bias=None) -> torch.Tensor:
    """Flash attention, ``[B, S, H, D]`` layout; differentiable in q, k, v.
    ``kv_segment_ids`` defaults to ``segment_ids``; ``scale`` to
    ``1 / sqrt(D)``."""
    s, kv_seg = _resolve(q, k, v, scale, segment_ids, kv_segment_ids)
    return _Flash.apply(q, k, v, s, bool(causal), segment_ids, kv_seg, bias,
                        False)


def flash_attention_with_lse(q, k, v, scale: Optional[float] = None,
                             causal: bool = False, segment_ids=None,
                             kv_segment_ids=None, bias=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, Sq, Hq, D], lse [B, Hq, Sq, 1] fp32)``, for callers that
    merge partial-KV results by their normalizers.  Differentiable in q, k,
    v through both outputs (the lse cotangent folds into ``delta``)."""
    s, kv_seg = _resolve(q, k, v, scale, segment_ids, kv_segment_ids)
    return _Flash.apply(q, k, v, s, bool(causal), segment_ids, kv_seg, bias,
                        True)


def flash_attention_bwd(q, k, v, out, lse, do, scale: Optional[float] = None,
                        causal: bool = False):
    """Standalone backward from forward residuals: ``(dq, dk, dv)``.  ``lse``
    is the global normalizer ``[B, Hq, Sq, 1]`` (a chunked caller passes the
    merged one).  Its results carry no autograd history."""
    s, _ = _resolve(q, k, v, scale, None, None)
    with torch.no_grad():
        return _bwd(q, k, v, out, lse, do, s, bool(causal), None, None, None)
