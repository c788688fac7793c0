"""Weight-only quantization: ``weight_quantize``, ``weight_dequantize``
and ``weight_only_linear``.

Counterpart of the weight-only half of ``paddle_tpu/nn/quant/__init__.py``
(``llm_int8_linear`` and the fp8 GEMM are not ported; ROADMAP queue 1).
Layouts are the JAX package's: the quantized weight keeps the logical
``[in, out]`` layout; int4 codes are halves-packed two to a byte along the
input dim (the low nibble holds rows ``[0, K/2)``, the high nibble rows
``[K/2, K)``, an odd K padded with a zero row); scales are fp32, ``[N]``
per output channel or ``[ceil(K / group_size), N]`` per group.
:func:`weight_quantize` gives the JAX package's codes and scales bit for
bit on the same fp32 input.

:func:`weight_only_linear` runs ``ops.quant_linear``: the plain version
for CPU tensors, the CUDA kernels for CUDA tensors.  On the CPU it follows
the JAX package's Pallas tier (fp32 scales), not its jnp fallback, which
rounds the scale to x's dtype before using it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import quant_linear as _ql

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "absmax_of", "codes_of", "pack_int4"]

ALGOS = ("weight_only_int8", "weight_only_int4", "llm.int8")


def _group_expand(scale: torch.Tensor, K: int, group_size: int
                  ) -> torch.Tensor:
    """[G, N] group scales -> [K, N] per-row scales."""
    return scale.repeat_interleave(group_size, dim=0)[:K]


def _check_group(group_size) -> bool:
    if group_size not in (-1, None, 64, 128):
        raise ValueError(f"group_size must be -1/64/128, got {group_size}")
    return group_size in (64, 128)


def absmax_of(wf: torch.Tensor, group_size: int = -1) -> torch.Tensor:
    """fp32 absmax of a ``[K, N]`` weight: ``[N]`` per output channel, or
    ``[ceil(K / gs), N]`` per group of ``group_size`` rows (64 / 128)."""
    if not _check_group(group_size):
        return wf.abs().amax(dim=0)
    K = wf.shape[0]
    G = -(-K // group_size)
    wp = torch.nn.functional.pad(wf, (0, 0, 0, G * group_size - K))
    return wp.reshape(G, group_size, -1).abs().amax(dim=1)


def codes_of(wf: torch.Tensor, scale: torch.Tensor, group_size: int = -1,
             int4: bool = False) -> torch.Tensor:
    """``clip(round(wf / scale), -qmax - 1, qmax)`` as int8 (round half to
    even, an IEEE division), int4 halves-packed into ``[ceil(K/2), N]``."""
    K = wf.shape[0]
    qmax = 7.0 if int4 else 127.0
    srow = _group_expand(scale, K, group_size) if _check_group(group_size) \
        else scale
    q = torch.clamp(torch.round(wf / srow), -qmax - 1, qmax).to(torch.int8)
    return pack_int4(q) if int4 else q


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7] ``[K, N]`` -> halves-packed ``[ceil(K/2), N]``
    (an odd K padded with a zero row)."""
    if q.shape[0] % 2:
        q = torch.nn.functional.pad(q, (0, 0, 0, 1))
    half = q.shape[0] // 2
    lo = q[:half].to(torch.int32) & 0x0F
    hi = (q[half:].to(torch.int32) & 0x0F) << 4
    packed = lo | hi                                  # 0..255
    packed = torch.where(packed >= 128, packed - 256, packed)
    return packed.to(torch.int8)


def weight_quantize(x: torch.Tensor, algo: str = "weight_only_int8",
                    arch=None, group_size: int = -1):
    """Absmax quantization of a ``[K, N]`` weight: ``(codes, scale)``.

    ``algo`` "weight_only_int8" / "llm.int8": int8 ``[K, N]``;
    "weight_only_int4": halves-packed int8 ``[ceil(K/2), N]``.
    ``group_size`` -1: scale ``[N]``; 64 / 128: ``[ceil(K/gs), N]``."""
    if algo not in ALGOS:
        raise ValueError(f"unknown quantize algo {algo!r}")
    grouped = _check_group(group_size)
    if grouped and algo == "llm.int8":
        raise ValueError("group_size is only supported for "
                         "weight_only_int8/int4, not llm.int8")
    wf = x.float()
    absmax = absmax_of(wf, group_size)
    int4 = algo == "weight_only_int4"
    qmax = 7.0 if int4 else 127.0
    # XLA turns the JAX package's division by the constant qmax into a
    # product with its fp32 reciprocal; the same product gives its scales
    scale = absmax.clamp_min(1e-8) * torch.tensor(1.0 / qmax,
                                                  dtype=torch.float32)
    return codes_of(wf, scale, group_size, int4), scale


_unpack_int4 = _ql.unpack_int4


def weight_dequantize(x: torch.Tensor, scale: torch.Tensor,
                      algo: str = "weight_only_int8", out_dtype="float32",
                      k: Optional[int] = None, group_size: int = -1
                      ) -> torch.Tensor:
    """Inverse of :func:`weight_quantize`: ``codes * scale`` in fp32, cast
    to ``out_dtype``."""
    from ..models.llama import torch_dtype
    grouped = _check_group(group_size)
    if algo == "weight_only_int4":
        qq = _unpack_int4(x, k if k is not None else x.shape[0] * 2)
    else:
        qq = x
    sf = scale.float()
    if grouped:
        sf = _group_expand(sf, qq.shape[0], group_size)
    return (qq.float() * sf).to(torch_dtype(out_dtype))


def weight_only_linear(x: torch.Tensor, weight: torch.Tensor, bias=None,
                       weight_scale: Optional[torch.Tensor] = None,
                       weight_dtype: str = "int8", arch=None,
                       group_size: int = -1) -> torch.Tensor:
    """``x @ dequant(weight) + bias`` through ``ops.quant_linear``;
    ``weight`` int8 ``[K, N]`` ("int8") or packed int4 ``[ceil(K/2), N]``
    ("int4")."""
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_dtype must be int8/int4, got "
                         f"{weight_dtype!r}")
    if weight_scale is None:
        raise ValueError("weight_only_linear needs weight_scale from "
                         "weight_quantize")
    gs = group_size if _check_group(group_size) else -1
    fn = (_ql.weight_only_matmul_int4 if weight_dtype == "int4"
          else _ql.weight_only_matmul)
    y = fn(x, weight, weight_scale, group_size=gs)
    return y if bias is None else y + bias
