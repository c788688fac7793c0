"""The flash-attention kernels on the card: ``flash_fwd``, ``flash_bwd_dq``
and ``flash_bwd_dkv`` (``kernels/csrc/flash_attention.cu``).

Each wrapper checks its tensors, allocates its outputs and launches one
kernel on the current stream; it takes CUDA tensors only and raises on
anything the kernels do not take (head_dim other than 64 or 128, a dtype
other than float32 / bfloat16).  Inputs are made contiguous (a no-op for
the training path's tensors), segment ids int32 and a bias fp32.
``delta = rowsum(out * do)`` is one torch reduction
(:func:`..flash_attention.flash_delta`), as the JAX package computes it
in XLA outside its kernels.
"""

from __future__ import annotations

import ctypes

import torch

from ...kernels import build
from . import layer

__all__ = ["HEAD_DIMS", "flash_fwd_cuda", "flash_bwd_dq_cuda",
           "flash_bwd_dkv_cuda", "flash_bwd_cuda"]

HEAD_DIMS = (64, 128)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _args(q, k, v, scale, causal, seg_q, seg_k, bias):
    """Check one launch's inputs; return ``(FlashArgs, tensors)`` with the
    checked (contiguous, int32 / fp32) tensors to keep alive."""
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError("flash attention kernels need CUDA tensors")
    dt, dev = q.dtype, q.device
    code = layer.dtype_code(dt)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim "
                         f"{' or '.join(map(str, HEAD_DIMS))}, got {D}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q heads ({Hq}) must be a multiple of kv heads "
                         f"({Hkv})")
    q, k, v = (t.contiguous() for t in (q, k, v))
    layer.check_tensor(q, "q", (B, Sq, Hq, D), dt, dev)
    layer.check_tensor(k, "k", (B, Sk, Hkv, D), dt, dev)
    layer.check_tensor(v, "v", (B, Sk, Hkv, D), dt, dev)
    if (seg_q is None) != (seg_k is None):
        raise ValueError("pass both segment id tensors or neither")
    if seg_q is not None:
        seg_q = seg_q.to(device=dev, dtype=torch.int32).contiguous()
        seg_k = seg_k.to(device=dev, dtype=torch.int32).contiguous()
        layer.check_tensor(seg_q, "segment_ids", (B, Sq), torch.int32, dev)
        layer.check_tensor(seg_k, "kv_segment_ids", (B, Sk), torch.int32,
                           dev)
    sb = sh = 0
    if bias is not None:
        if (bias.ndim != 4 or bias.shape[0] not in (1, B)
                or bias.shape[1] not in (1, Hq)
                or tuple(bias.shape[2:]) != (Sq, Sk)):
            raise ValueError(f"bias must be [B|1, Hq|1, Sq, Sk] = "
                             f"[{B}|1, {Hq}|1, {Sq}, {Sk}], got "
                             f"{tuple(bias.shape)}")
        bias = bias.to(device=dev, dtype=torch.float32).contiguous()
        sh = 0 if bias.shape[1] == 1 else Sq * Sk
        sb = 0 if bias.shape[0] == 1 else bias.shape[1] * Sq * Sk
    a = build.FlashArgs(dtype=code, B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv, D=D,
                        causal=int(bool(causal)), bias_sb=sb, bias_sh=sh,
                        scale=float(scale), q=q.data_ptr(), k=k.data_ptr(),
                        v=v.data_ptr(), bias=_ptr(bias), seg_q=_ptr(seg_q),
                        seg_k=_ptr(seg_k))
    return a, [q, k, v, seg_q, seg_k, bias]


def _row_f32(t, B, Hq, Sq, name, dev):
    """lse / delta ``[B, Hq, Sq, 1]`` -> contiguous fp32 ``[B, Hq, Sq]``."""
    t = t.reshape(B, Hq, Sq).to(device=dev, dtype=torch.float32).contiguous()
    return layer.check_tensor(t, name, (B, Hq, Sq), torch.float32, dev)


def _launch(fn_name, a):
    build.check(getattr(build.library(), fn_name)(ctypes.byref(a),
                                                  layer.stream_handle()),
                fn_name)


def flash_fwd_cuda(q, k, v, scale, causal, seg_q=None, seg_k=None,
                   bias=None):
    """``(out [B, Sq, Hq, D], lse [B, Hq, Sq, 1] fp32)`` from ``flash_fwd``."""
    a, keep = _args(q, k, v, scale, causal, seg_q, seg_k, bias)
    B, Sq, Hq, D = q.shape
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq, 1), dtype=torch.float32, device=q.device)
    a.out, a.lse = out.data_ptr(), lse.data_ptr()
    _launch("pt_flash_fwd", a)
    del keep
    return out, lse


def _bwd_args(q, k, v, do, lse, delta, scale, causal, seg_q, seg_k, bias):
    a, keep = _args(q, k, v, scale, causal, seg_q, seg_k, bias)
    B, Sq, Hq, D = q.shape
    do = do.contiguous()
    layer.check_tensor(do, "do", (B, Sq, Hq, D), q.dtype, q.device)
    lse = _row_f32(lse, B, Hq, Sq, "lse", q.device)
    delta = _row_f32(delta, B, Hq, Sq, "delta", q.device)
    a.dout, a.lse, a.delta = do.data_ptr(), lse.data_ptr(), delta.data_ptr()
    return a, keep + [do, lse, delta]


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal, seg_q=None,
                      seg_k=None, bias=None):
    """``dq [B, Sq, Hq, D]`` from ``flash_bwd_dq``."""
    a, keep = _bwd_args(q, k, v, do, lse, delta, scale, causal, seg_q, seg_k,
                        bias)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    a.dq = dq.data_ptr()
    _launch("pt_flash_bwd_dq", a)
    del keep
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal, seg_q=None,
                       seg_k=None, bias=None):
    """``(dk, dv) [B, Sk, Hkv, D]`` from ``flash_bwd_dkv``."""
    a, keep = _bwd_args(q, k, v, do, lse, delta, scale, causal, seg_q, seg_k,
                        bias)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    a.dk, a.dv = dk.data_ptr(), dv.data_ptr()
    _launch("pt_flash_bwd_dkv", a)
    del keep
    return dk, dv


def flash_bwd_cuda(q, k, v, out, lse, do, scale, causal, seg_q=None,
                   seg_k=None, bias=None, dlse=None):
    """``(dq, dk, dv)``: delta by one torch reduction, then both kernels."""
    from ..flash_attention import flash_delta
    delta = flash_delta(out, do, dlse)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal, seg_q,
                           seg_k, bias)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal,
                                seg_q, seg_k, bias)
    return dq, dk, dv
