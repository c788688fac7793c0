"""Weight-only quantized matmul: ``x @ dequant(int8 or packed int4 w)``.

Counterpart of ``paddle_tpu/ops/pallas/quant_linear.py``.  Layouts are
the JAX package's: x ``[..., K]`` (fp32 or bf16); ``wq`` int8 ``[K, N]``,
or int4 halves-packed into int8 ``[ceil(K/2), N]`` (the low nibble,
sign-extended, holds rows ``[0, K/2)``, the high nibble rows
``[K/2, K)``; an odd K pads x with one zero column); ``scale`` fp32
``[N]`` per output channel or ``[G, N]`` with ``group_size`` (64 or 128)
rows per group.  The output is in x's dtype.

Two versions and no third:

* the plain PyTorch version (:func:`weight_only_matmul_ref`,
  :func:`weight_only_matmul_int4_ref`) with the Pallas tier's rounding
  points: the codes cast to x's dtype, fp32 partial products, and either
  the fp32 scale multiplied into the partial product of each run of rows
  that lies inside one group (per-channel, and groups of 128), or, where
  the Pallas kernel's 128-row block spans several groups (groups of 64),
  the weight tile dequantized in x's dtype (the scale rounded to x's
  dtype, the product rounded again) before the product.  int4 groups that
  the Pallas kernel refuses (``ceil(K/2)`` not a multiple of the group)
  take the dequantized-tile rule too.  It runs for tensors on the CPU.
* the hand-written CUDA kernels (:mod:`.cuda.quant_linear`) for tensors
  on a CUDA device: they launch or raise.  The product stays inside the
  kernel; nothing dequantizes a whole weight.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cuda import quant_linear as _cuda

__all__ = ["GROUP_SIZES", "weight_only_matmul", "weight_only_matmul_int4",
           "weight_only_matmul_ref", "weight_only_matmul_int4_ref",
           "unpack_int4", "scale_mode"]

GROUP_SIZES = (-1, 64, 128)


def _group(group_size) -> int:
    gs = -1 if group_size is None else int(group_size)
    if gs not in GROUP_SIZES:
        raise ValueError(f"group_size must be -1, 64 or 128, got "
                         f"{group_size}")
    return gs


def unpack_int4(packed: torch.Tensor, k: Optional[int] = None
                ) -> torch.Tensor:
    """Halves-packed int8 ``[ceil(K/2), N]`` -> int8 codes ``[K, N]``
    (``k`` None keeps all ``2 * ceil(K/2)`` rows)."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8                   # sign-extended low nibble
    hi = p >> 4                                # arithmetic shift
    q = torch.cat([lo, hi], dim=0).to(torch.int8)
    return q if k is None else q[:k]


def scale_mode(group_size: int, int4_half: Optional[int] = None) -> str:
    """``"post"``: the fp32 scale multiplies each group's fp32 partial
    product; ``"tile"``: the weight is dequantized in x's dtype first.
    ``int4_half`` is ``ceil(K/2)`` for int4 codes."""
    gs = _group(group_size)
    if gs == -1:
        return "post"
    if gs < 128 or (int4_half is not None and int4_half % gs):
        return "tile"
    return "post"


def _check_scale(scale, K, N, gs):
    G = 1 if gs == -1 else -(-K // gs)
    want = (N,) if gs == -1 else (G, N)
    if tuple(scale.shape) != want:
        raise ValueError(f"scale must be {list(want)} for K {K}, N {N}, "
                         f"group_size {gs}; got {tuple(scale.shape)}")


def _matmul_codes(x2, q, scale, gs, mode):
    """fp32 ``x2 [M, K'] @ dequant(q [K', N])`` by the plain rounding
    rules; rows of q past the scale's groups are zero codes."""
    Kq = q.shape[0]
    s = scale.float().reshape(-1, scale.shape[-1])
    if mode == "tile":
        rows = torch.arange(Kq, device=q.device) // gs
        srow = s[rows.clamp(max=s.shape[0] - 1)].to(x2.dtype)
        w = q.to(x2.dtype) * srow
        return x2.float() @ w.float()
    if gs == -1:
        return (x2.float() @ q.float()) * s[0]
    out = 0
    for g in range(s.shape[0]):
        r0, r1 = g * gs, min((g + 1) * gs, Kq)
        if r0 < r1:
            out = out + (x2[:, r0:r1].float() @ q[r0:r1].float()) * s[g]
    return out


def weight_only_matmul_ref(x, wq, scale, out_dtype=None,
                           group_size: int = -1) -> torch.Tensor:
    """Plain ``x [..., K] @ dequant(wq int8 [K, N], scale)``."""
    gs = _group(group_size)
    K, N = wq.shape
    if x.shape[-1] != K:
        raise ValueError(f"x has K {x.shape[-1]}, wq has {K} rows")
    _check_scale(scale, K, N, gs)
    x2 = x.reshape(-1, K)
    y = _matmul_codes(x2, wq, scale, gs, scale_mode(gs))
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], N)


def weight_only_matmul_int4_ref(x, wq_packed, scale, out_dtype=None,
                                group_size: int = -1) -> torch.Tensor:
    """Plain ``x [..., K] @ dequant(int4 halves-packed [ceil(K/2), N])``."""
    gs = _group(group_size)
    half, N = wq_packed.shape
    K = x.shape[-1]
    if half != -(-K // 2):
        raise ValueError(f"x has K {K}: packed int4 codes need ceil(K/2) = "
                         f"{-(-K // 2)} rows, got {half}")
    _check_scale(scale, K, N, gs)
    x2 = x.reshape(-1, K)
    if 2 * half > K:                            # odd K: one zero column
        x2 = torch.nn.functional.pad(x2, (0, 2 * half - K))
    y = _matmul_codes(x2, unpack_int4(wq_packed), scale, gs,
                      scale_mode(gs, half))
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], N)


def _dispatch(x, out_dtype):
    if x.device.type == "cuda":
        if out_dtype not in (None, x.dtype):
            raise ValueError(f"the CUDA kernels write x's dtype {x.dtype}, "
                             f"not {out_dtype}")
        return True
    if x.device.type != "cpu":
        raise ValueError(f"weight-only matmul runs on CUDA or CPU tensors, "
                         f"got {x.device}")
    return False


def weight_only_matmul(x, wq, scale, out_dtype=None,
                       group_size: int = -1) -> torch.Tensor:
    """int8 weight-only matmul: the plain version for CPU tensors, the
    CUDA kernels for CUDA tensors."""
    if _dispatch(x, out_dtype):
        gs = _group(group_size)
        return _cuda.weight_only_matmul_cuda(
            x, wq, scale, gs, int4=False, tile=scale_mode(gs) == "tile")
    return weight_only_matmul_ref(x, wq, scale, out_dtype, group_size)


def weight_only_matmul_int4(x, wq_packed, scale, out_dtype=None,
                            group_size: int = -1) -> torch.Tensor:
    """int4 (halves-packed) weight-only matmul: the plain version for CPU
    tensors, the CUDA kernels for CUDA tensors."""
    if _dispatch(x, out_dtype):
        gs = _group(group_size)
        return _cuda.weight_only_matmul_cuda(
            x, wq_packed, scale, gs, int4=True,
            tile=scale_mode(gs, wq_packed.shape[0]) == "tile")
    return weight_only_matmul_int4_ref(x, wq_packed, scale, out_dtype,
                                       group_size)
