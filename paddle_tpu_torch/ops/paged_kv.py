"""Paged KV pool helpers (counterpart of ``paddle_tpu/ops/paged_kv.py``).

A pool is one tensor ``[num_blocks, block_size, Hkv, D]`` per K and V
(the engine keeps ``[L, ...]`` and hands each layer its slice), or an
int8 :class:`QuantizedKVPool` of the same logical shape with one fp32
scale per (page, token, head); sequences own pages through an int32 block
table, ``-1`` = unmapped.  Unlike the JAX package, writes go into the
pools IN PLACE.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["PagedKVGeometryError", "QuantizedKVPool",
           "validate_paged_decode_geometry", "pool_geometry",
           "zeros_kv_pool", "paged_append", "paged_decode_attention",
           "is_quantized_pool", "quantize_kv", "dequantize_kv",
           "kv_page_bytes", "layer_pool", "KV_SCALE_EPS"]

NEG_INF = -1e30

# Scale floor for int8 KV quantization (all-zero rows — fresh pool pages —
# must not divide by zero; their codes stay 0 and dequantize to 0).
KV_SCALE_EPS = 1e-8


class QuantizedKVPool(NamedTuple):
    """An int8 paged-KV pool: ``data`` holds the codes with the logical
    shape of a full-width pool (``[..., NB, BS, Hkv, D]``), ``scale`` one
    fp32 absmax / 127 scale per (page, token, kv head) (``[..., NB, BS,
    Hkv]``).  Per-token scales are append-local: a write replaces a code
    row and its scale together, so a stored token never changes
    representation."""
    data: torch.Tensor
    scale: torch.Tensor


def is_quantized_pool(pool) -> bool:
    return isinstance(pool, QuantizedKVPool)


def layer_pool(pool, i: int):
    """Layer ``i``'s ``[NB, BS, Hkv, D]`` view of an ``[L, ...]`` pool
    (writes into the view land in the pool)."""
    if is_quantized_pool(pool):
        return QuantizedKVPool(pool.data[i], pool.scale[i])
    return pool[i]


def quantize_kv(kv: torch.Tensor):
    """``[..., H, D]`` rows -> ``(int8 codes, fp32 scale [..., H])``, one
    absmax scale per (token, head): ``max(absmax, 1e-8) / 127`` by an IEEE
    division, codes ``clip(round(x / scale), -127, 127)`` (round half to
    even)."""
    kf = kv.float()
    absmax = kf.abs().amax(dim=-1)
    # a tensor divisor: on the card a Python scalar one becomes a product
    # with its reciprocal, which is not the division
    scale = absmax.clamp_min(KV_SCALE_EPS) / torch.full_like(absmax, 127.0)
    codes = torch.clamp(torch.round(kf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def dequantize_kv(data: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """int8 codes ``[..., H, D]`` and scales ``[..., H]`` -> ``codes x
    scale`` in fp32, cast to ``dtype``."""
    return (data.float() * scale.float()[..., None]).to(dtype)


def kv_page_bytes(block_size: int, kv_heads: int, head_dim: int, *,
                  dtype_itemsize: int = 2, kv_quant: bool = False) -> int:
    """Bytes one pool page (k or v, one layer) occupies: quantized pages
    pay one byte a code plus a 4-byte scale a (token, head)."""
    elems = block_size * kv_heads * head_dim
    if kv_quant:
        return elems + block_size * kv_heads * 4
    return elems * dtype_itemsize


class PagedKVGeometryError(ValueError):
    """A model/pool geometry the paged decode path cannot serve; the
    message names the offending shapes."""


def pool_geometry(pool):
    """(num_blocks, block_size, kv_heads, head_dim) of a pool, full-width
    or quantized."""
    arr = pool.data if is_quantized_pool(pool) else pool
    return tuple(arr.shape[-4:])


def zeros_kv_pool(shape, dtype, device=None, *, kv_quant: bool = False):
    """A fresh zero pool of ``shape`` ``[..., NB, BS, Hkv, D]``: a tensor
    of ``dtype``, or with ``kv_quant`` a :class:`QuantizedKVPool` of int8
    codes and fp32 scales."""
    from ..device import resolve_device
    dev = resolve_device(device)
    shape = tuple(shape)
    if kv_quant:
        return QuantizedKVPool(
            data=torch.zeros(shape, dtype=torch.int8, device=dev),
            scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
    return torch.zeros(shape, dtype=dtype, device=dev)


def validate_paged_decode_geometry(q, pool_k, pool_v, block_table,
                                   lengths, *, op: str =
                                   "paged_decode_attention") -> None:
    """Shape contract of one paged decode step; ``q`` may be the
    [B, Hq, D] query or its shape tuple.  Raises
    :class:`PagedKVGeometryError` naming the offending geometry."""
    q_shape = tuple(q if isinstance(q, (tuple, list)) else q.shape)
    if len(q_shape) != 3:
        raise PagedKVGeometryError(
            f"{op}: q must be [B, Hq, D] (one token per sequence), got "
            f"shape {q_shape}")
    B, Hq, D = q_shape
    kq, vq = is_quantized_pool(pool_k), is_quantized_pool(pool_v)
    if kq != vq:
        raise PagedKVGeometryError(
            f"{op}: k/v pools disagree on quantization — k is "
            f"{'int8' if kq else 'full-width'}, v is "
            f"{'int8' if vq else 'full-width'}")
    if kq:
        for name, p in (("k", pool_k), ("v", pool_v)):
            if p.data.dtype != torch.int8:
                raise PagedKVGeometryError(
                    f"{op}: quantized {name} pool data must be int8, "
                    f"got {p.data.dtype}")
            if tuple(p.scale.shape) != tuple(p.data.shape[:-1]):
                raise PagedKVGeometryError(
                    f"{op}: quantized {name} pool scale must be per "
                    f"(page, token, head) {tuple(p.data.shape[:-1])}, "
                    f"got {tuple(p.scale.shape)}")
        pool_k, pool_v = pool_k.data, pool_v.data
    if pool_k.ndim != 4 or pool_v.ndim != 4:
        raise PagedKVGeometryError(
            f"{op}: pools must be [num_blocks, block_size, Hkv, D], got "
            f"k {tuple(pool_k.shape)} / v {tuple(pool_v.shape)}")
    if tuple(pool_k.shape) != tuple(pool_v.shape):
        raise PagedKVGeometryError(
            f"{op}: k/v pools disagree: {tuple(pool_k.shape)} vs "
            f"{tuple(pool_v.shape)}")
    NB, BS, Hkv, Dp = pool_k.shape
    if Dp != D:
        raise PagedKVGeometryError(
            f"{op}: head_dim mismatch — q has D={D}, the KV pool was "
            f"built with D={Dp} (pool {tuple(pool_k.shape)})")
    if BS < 1:
        raise PagedKVGeometryError(
            f"{op}: block_size must be >= 1, pool has {BS}")
    if Hkv < 1 or Hq % Hkv != 0:
        raise PagedKVGeometryError(
            f"{op}: q heads ({Hq}) must be a positive multiple of kv "
            f"heads ({Hkv}) — GQA groups must divide evenly")
    bt_shape = tuple(np.shape(block_table))
    if len(bt_shape) != 2 or bt_shape[0] != B:
        raise PagedKVGeometryError(
            f"{op}: block_table must be [B={B}, max_blocks], got "
            f"{bt_shape}")
    len_shape = tuple(np.shape(lengths))
    if len_shape != (B,):
        raise PagedKVGeometryError(
            f"{op}: lengths must be [B={B}], got {len_shape}")


def paged_append(pool_k, pool_v, k_new, v_new, block_table, lengths,
                 block_size: int):
    """Write each sequence's new k/v token ``[B, Hkv, D]`` at position
    ``lengths[b]`` through its block table, IN PLACE.  A write whose page
    is unmapped (``-1``) or lies past the table is dropped, never wrapped
    onto another sequence's page.  A quantized pool takes the rows'
    :func:`quantize_kv` codes and scales at the same (page, offset).
    Returns ``(pool_k, pool_v)``."""
    lengths = lengths.long()
    MB = block_table.shape[1]
    blk_idx = lengths // block_size
    off = lengths % block_size
    inside = blk_idx < MB
    phys = torch.gather(block_table.long(), 1,
                        blk_idx.clamp(max=MB - 1)[:, None])[:, 0]
    keep = inside & (phys >= 0)
    if is_quantized_pool(pool_k):
        for pool, new in ((pool_k, k_new), (pool_v, v_new)):
            codes, scale = quantize_kv(new[keep])
            pool.data[phys[keep], off[keep]] = codes
            pool.scale[phys[keep], off[keep]] = scale
        return pool_k, pool_v
    pool_k[phys[keep], off[keep]] = k_new[keep].to(pool_k.dtype)
    pool_v[phys[keep], off[keep]] = v_new[keep].to(pool_v.dtype)
    return pool_k, pool_v


def paged_decode_attention(q, pool_k, pool_v, block_table, lengths,
                           scale: Optional[float] = None):
    """One decode step over a paged cache.  ``q`` [B, Hq, D];
    ``lengths`` [B] tokens valid AFTER appending the current one.
    Unmapped table entries read page 0 (masked past ``lengths``); logits,
    softmax and the weighted sum run in fp32 (a quantized pool's pages
    are dequantized to fp32).  Returns [B, Hq, D]."""
    validate_paged_decode_geometry(q, pool_k, pool_v, block_table, lengths)
    B, Hq, D = q.shape
    NB, BS, Hkv, _ = pool_geometry(pool_k)
    MB = block_table.shape[1]
    G = Hq // Hkv
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    bt = block_table.long().clamp(min=0)
    if is_quantized_pool(pool_k):
        k = dequantize_kv(pool_k.data[bt], pool_k.scale[bt])
        v = dequantize_kv(pool_v.data[bt], pool_v.scale[bt])
    else:
        k, v = pool_k[bt], pool_v[bt]
    k = k.reshape(B, MB * BS, Hkv, D).float()
    v = v.reshape(B, MB * BS, Hkv, D).float()
    qg = q.reshape(B, Hkv, G, D).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k) * s
    mask = torch.arange(MB * BS, device=q.device)[None, None, None, :] \
        < lengths.to(q.device)[:, None, None, None]
    logits = torch.where(mask, logits, torch.tensor(
        NEG_INF, dtype=torch.float32, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v)
    return out.reshape(B, Hq, D).to(q.dtype)
