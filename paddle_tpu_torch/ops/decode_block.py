"""One transformer layer for the serving path: the ``decode_block`` and
``prefill_block`` ops (counterpart of ``paddle_tpu/ops/decode_block.py``).
Two layer kinds:

* a Llama layer: RMSNorm, split q / k / v, rotate-half RoPE, SwiGLU, no
  biases;
* a GPT layer: LayerNorm with bias, one fused qkv product with its bias
  (split per head as ``[q | k | v]``), learned positions (no rotation),
  biased out-projection and a ``fc1 + b -> gelu(tanh) -> fc2 + b`` FFN.

Either kind takes its matmuls full-width or weight-only int8 / int4 (per
channel or groups of 64 / 128), over a full-width or an int8 paged-KV
pool.

Each op has two versions and no third:

* the plain PyTorch version (:func:`decode_block_ref`,
  :func:`prefill_block_ref`) — the same per-op chain, order and dtypes
  as the JAX package's reference tier (``decode_block_xla`` /
  ``prefill_block_xla``).  It runs for tensors on the CPU, and
  ``chip_smoke.py`` holds the kernels against it on the card;
* the hand-written CUDA kernels behind :mod:`.cuda.decode_block` /
  :mod:`.cuda.prefill_block`, for tensors on a CUDA device.  That path
  launches the kernels or raises; it never gives way to the plain
  version.

Unlike the JAX package, the pools are updated IN PLACE: the new tokens'
K/V rows are written into ``pool_k`` / ``pool_v`` and the same tensors
are returned.  A quantized pool (``paged_kv.QuantizedKVPool``) takes each
new row's int8 codes and fp32 scale; decode reads its pages dequantized to
fp32, prefill dequantized to the model dtype, as the JAX reference tier
does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .paged_kv import (dequantize_kv, is_quantized_pool, paged_append,
                       paged_decode_attention, pool_geometry, quantize_kv,
                       validate_paged_decode_geometry)

__all__ = ["DecodeBlockSpec", "decode_block_spec", "rotate_half",
           "make_norm", "make_mm", "make_ffn", "make_norm_ffn",
           "causal_mask", "decode_block_ref", "prefill_block_ref",
           "decode_block", "prefill_block"]


@dataclasses.dataclass(frozen=True)
class DecodeBlockSpec:
    """Static shape and variant of one layer's step: the Llama family
    (RMSNorm, split q/k/v, rotate-half RoPE, SwiGLU) or the GPT family
    (LayerNorm with bias, fused qkv, learned positions — no RoPE — and a
    GELU MLP with biases).  The fields, their defaults and their checks
    are the JAX package's.  ``weight_dtype`` "int8" / "int4": the matmul
    weights live in the layer's dict as ``<name>__q`` codes (int4
    halves-packed) and ``<name>__s`` fp32 scales (the
    ``quantization.serve`` export layout), one a channel or, with
    ``group_size`` 64 / 128, one a (row group, channel); the norm gains and
    the biases stay full-width."""
    hidden: int
    num_heads: int
    kv_heads: int
    head_dim: int
    block_size: int                   # KV page size (pool geometry)
    norm: str = "rms"                 # "rms" | "ln"
    activation: str = "swiglu"        # "swiglu" | "gelu"
    eps: float = 1e-5
    rope: bool = True
    fused_qkv: bool = False           # GPT layout: qkv_w / qkv_b
    bias: bool = False                # GPT layout: proj / fc biases
    weight_dtype: Optional[str] = None   # None | "int8" | "int4"
    group_size: int = -1                 # -1 | 64 | 128

    def __post_init__(self):
        if self.kv_heads < 1 or self.num_heads % self.kv_heads:
            raise ValueError(
                f"num_heads ({self.num_heads}) must be a multiple of "
                f"kv_heads ({self.kv_heads})")
        if self.norm not in ("rms", "ln"):
            raise ValueError(f"norm must be 'rms' or 'ln', got {self.norm!r}")
        if self.activation not in ("swiglu", "gelu"):
            raise ValueError("activation must be 'swiglu' or 'gelu', got "
                             f"{self.activation!r}")
        if self.fused_qkv and self.kv_heads != self.num_heads:
            raise ValueError(
                "fused_qkv implies MHA (one [H, 3*H] projection); got "
                f"num_heads={self.num_heads}, kv_heads={self.kv_heads}")
        if self.weight_dtype not in (None, "int8", "int4"):
            raise ValueError("weight_dtype must be None, 'int8' or "
                             f"'int4', got {self.weight_dtype!r}")
        if self.group_size not in (-1, 64, 128):
            raise ValueError(f"group_size must be -1/64/128, got "
                             f"{self.group_size}")
        if self.weight_dtype is None and self.group_size != -1:
            raise ValueError("group_size requires weight_dtype")

    @property
    def llama_layout(self) -> bool:
        """Every variant field at the Llama layer's value."""
        return (self.norm, self.activation, self.rope, self.fused_qkv,
                self.bias) == ("rms", "swiglu", True, False, False)


def decode_block_spec(cfg, block_size: int,
                      weight_dtype: Optional[str] = None,
                      group_size: int = -1) -> DecodeBlockSpec:
    """Spec for a model config, as the JAX package maps it: a config with
    ``rms_norm_eps`` (Llama family) to rms / SwiGLU / RoPE, one with
    ``layer_norm_eps`` (GPT family) to ln / GELU / no RoPE / fused qkv /
    biases.  ``weight_dtype`` / ``group_size`` select the weight-only
    quantized layer of either family (the parameters carry ``__q`` /
    ``__s`` leaves from ``quantization.quantize_params_for_serving``).  MoE configs are
    outside this port's slices (ROADMAP queue 1)."""
    if getattr(cfg, "moe_num_experts", 0):
        raise NotImplementedError(
            "MoE FFNs are not ported yet — ROADMAP queue 1")
    if hasattr(cfg, "rms_norm_eps"):
        return DecodeBlockSpec(
            hidden=cfg.hidden_size, num_heads=cfg.num_heads,
            kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
            block_size=block_size, norm="rms", activation="swiglu",
            eps=cfg.rms_norm_eps, rope=True, weight_dtype=weight_dtype,
            group_size=group_size)
    return DecodeBlockSpec(
        hidden=cfg.hidden_size, num_heads=cfg.num_heads,
        kv_heads=cfg.num_heads, head_dim=cfg.head_dim,
        block_size=block_size, norm="ln", activation="gelu",
        eps=cfg.layer_norm_eps, rope=False, fused_qkv=True, bias=True,
        weight_dtype=weight_dtype, group_size=group_size)


def rotate_half(x):
    """RoPE rotate-half convention ([-x2, x1])."""
    d2 = x.shape[-1] // 2
    return torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)


def make_norm(spec: DecodeBlockSpec) -> Callable:
    """``norm(x, w, b=None)`` — fp32 statistics, scale applied in the input
    dtype (a bf16 result rounds at each step, as in the JAX package).
    RMS: ``(x * rsqrt(mean(x^2) + eps)) * w``; LayerNorm: mean and
    variance in fp32, ``(x - mean) * rsqrt(var + eps)`` in fp32 rounded to
    x's dtype, then ``* w + b`` in x's dtype."""
    eps = spec.eps
    if spec.norm == "rms":
        def norm(x, w, b=None):
            ms = x.float().square().mean(-1, keepdim=True)
            return (x * torch.rsqrt(ms + eps).to(x.dtype)) * w
        return norm

    def norm(x, w, b=None):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, unbiased=False, keepdim=True)
        out = (x32 - mu) * torch.rsqrt(var + eps)
        return out.to(x.dtype) * w + b
    return norm


def make_mm(spec: DecodeBlockSpec) -> Callable:
    """``mm(lp, name, y)``, the one matmul of every plain layer.  Full
    width: ``y @ lp[name]`` (weights ``[in, out]``).  Weight-only: y in
    fp32 times the fp32 codes, then times the per-channel scale; grouped
    scales dequantize the fp32 weight first (a per-channel product cannot
    hold per-group scales); the result rounded to y's dtype — the JAX
    reference tier's split."""
    if spec.weight_dtype is None:
        def mm(lp, name, y):
            return y @ lp[name]
        return mm
    from ..nn.quant import _group_expand
    from .quant_linear import unpack_int4
    wdt, gs = spec.weight_dtype, spec.group_size

    def mm(lp, name, y):
        wq, s = lp[name + "__q"], lp[name + "__s"]
        K = y.shape[-1]
        if wdt == "int4":
            wq = unpack_int4(wq, K)
        y32, s32 = y.float(), s.float()
        if gs == -1:
            out = (y32 @ wq.float()) * s32
        else:
            out = y32 @ (wq.float() * _group_expand(s32, K, gs))
        return out.to(y.dtype)
    return mm


def make_ffn(spec: DecodeBlockSpec) -> Callable:
    """``ffn(lp, y)``: ``down(silu(gate(y)) * up(y))`` (SwiGLU), or
    ``fc2(gelu(fc1(y) + fc1_b, tanh)) + fc2_b`` (GELU), each product
    rounded to y's dtype before its bias or activation."""
    mm = make_mm(spec)
    if spec.activation == "swiglu":
        def ffn(lp, y):
            return mm(lp, "down_w", F.silu(mm(lp, "gate_w", y))
                      * mm(lp, "up_w", y))
        return ffn

    def ffn(lp, y):
        return mm(lp, "fc2_w", F.gelu(mm(lp, "fc1_w", y) + lp["fc1_b"],
                                      approximate="tanh")) + lp["fc2_b"]
    return ffn


def make_norm_ffn(cfg, weight_dtype: Optional[str] = None,
                  group_size: int = -1):
    """The engine's (norm, ffn) closure pair for a dense Llama config (as
    in the JAX package, Llama only: a GPT layer reaches the serving
    kernels through :func:`decode_block` / :func:`prefill_block`)."""
    if not hasattr(cfg, "rms_norm_eps"):
        raise ValueError("make_norm_ffn takes a Llama-family config (the "
                         "engine's closures); GPT layers run through "
                         "decode_block / prefill_block")
    if getattr(cfg, "moe_num_experts", 0) and weight_dtype is not None:
        raise NotImplementedError(
            "weight-only quantization is not supported with MoE FFNs "
            "(expert banks are not wired into the PTQ export)")
    spec = decode_block_spec(cfg, 1, weight_dtype, group_size)
    return make_norm(spec), make_ffn(spec)


def _qkv(y, lp, spec: DecodeBlockSpec, leading, mm):
    """Project the normed stream into per-head q / k / v.  Fused: one
    product plus ``qkv_b``, reshaped to ``[..., H, 3D]`` and split along
    the last axis (q, k and v interleaved per head)."""
    H, Hkv, D = spec.num_heads, spec.kv_heads, spec.head_dim
    if spec.fused_qkv:
        qkv = (mm(lp, "qkv_w", y) + lp["qkv_b"]).reshape(*leading, H, 3 * D)
        return qkv.split(D, dim=-1)
    q = mm(lp, "q_w", y).reshape(*leading, H, D)
    k = mm(lp, "k_w", y).reshape(*leading, Hkv, D)
    v = mm(lp, "v_w", y).reshape(*leading, Hkv, D)
    return q, k, v


def _proj(attn, lp, spec: DecodeBlockSpec, mm):
    """The out-projection, with ``proj_b`` when the layer has biases."""
    proj = mm(lp, "proj_w" if spec.fused_qkv else "o_w", attn)
    return proj + lp["proj_b"] if spec.bias else proj


def decode_block_ref(x, lp, pool_k, pool_v, block_table, lengths, cos, sin,
                     *, spec: DecodeBlockSpec):
    """Plain version: one decode token per sequence through the layer's
    per-op chain.  ``x`` [B, H]; ``cos``/``sin`` [B, D] rows at each
    sequence's position ``lengths[b]`` (unused, and may be None, when
    ``spec.rope`` is off).  Appends the new K/V in place and returns
    ``(x_out, pool_k, pool_v)``."""
    B = x.shape[0]
    norm = make_norm(spec)
    mm = make_mm(spec)
    ffn = make_ffn(spec)
    y = norm(x, lp["ln1_w"], lp.get("ln1_b"))
    q, k, v = _qkv(y, lp, spec, (B,), mm)
    if spec.rope:
        def rope1(t):                                     # [B, h, D]
            return t * cos[:, None, :] + rotate_half(t) * sin[:, None, :]
        q, k = rope1(q), rope1(k)
    paged_append(pool_k, pool_v, k, v, block_table, lengths,
                 spec.block_size)
    attn = paged_decode_attention(q, pool_k, pool_v, block_table,
                                  lengths + 1)
    x = x + _proj(attn.reshape(B, -1), lp, spec, mm)
    x = x + ffn(lp, norm(x, lp["ln2_w"], lp.get("ln2_b")))
    return x, pool_k, pool_v


def causal_mask(start, Ts: int, width: int, device):
    """``[1, 1, Ts, width]`` mask: row i sees pool positions <= start+i."""
    pos = start + torch.arange(Ts, device=device)
    jpos = torch.arange(width, device=device)[None, None, None, :]
    return jpos <= pos[None, None, :, None]


def prefill_block_ref(x, lp, pool_k, pool_v, blk, off, bt_row, cos, sin, *,
                      spec: DecodeBlockSpec, start: int,
                      scale: Optional[float] = None):
    """Plain version of the chunk-fill layer: ``Ts`` prompt tokens of ONE
    sequence at positions ``start + [0, Ts)``.  ``x`` [1, Ts, H];
    ``blk``/``off`` [Ts] write targets (a row whose ``blk`` lies outside
    ``[0, NB)`` writes nothing — the padded tail of a bucket); ``bt_row``
    [MB]; ``cos``/``sin`` [Ts, D] (None when ``spec.rope`` is off).
    Writes the tile's K/V in place, attends over the sequence's gathered
    pages under the causal mask of :func:`causal_mask`, returns
    ``(x_out, pool_k, pool_v)``.  A quantized pool takes the tile's codes
    and scales, and its gathered pages are dequantized to the model
    dtype."""
    from ..models.generation import _dense_masked_attention
    Ts = x.shape[1]
    Hkv, D = spec.kv_heads, spec.head_dim
    mask = causal_mask(start, Ts, bt_row.shape[0] * spec.block_size,
                       x.device)
    norm = make_norm(spec)
    mm = make_mm(spec)
    ffn = make_ffn(spec)
    s = scale if scale is not None else 1.0 / (D ** 0.5)
    y = norm(x, lp["ln1_w"], lp.get("ln1_b"))
    q, k, v = _qkv(y, lp, spec, (1, Ts), mm)
    if spec.rope:
        def rope1(t):                                     # [1, Ts, h, D]
            return (t * cos[None, :, None, :]
                    + rotate_half(t) * sin[None, :, None, :])
        q, k = rope1(q), rope1(k)
    NB = pool_geometry(pool_k)[0]
    blk = blk.long()
    keep = (blk >= 0) & (blk < NB)
    bk, ok = blk[keep], off.long()[keep]
    bt0 = bt_row.long().clamp(min=0)
    if is_quantized_pool(pool_k):
        for pool, new in ((pool_k, k), (pool_v, v)):
            codes, sc = quantize_kv(new[0][keep])
            pool.data[bk, ok] = codes
            pool.scale[bk, ok] = sc
        k_all = dequantize_kv(pool_k.data[bt0], pool_k.scale[bt0], k.dtype)
        v_all = dequantize_kv(pool_v.data[bt0], pool_v.scale[bt0], v.dtype)
    else:
        pool_k[bk, ok] = k[0][keep]
        pool_v[bk, ok] = v[0][keep]
        k_all, v_all = pool_k[bt0], pool_v[bt0]
    k_all = k_all.reshape(1, -1, Hkv, D)
    v_all = v_all.reshape(1, -1, Hkv, D)
    attn = _dense_masked_attention(q, k_all, v_all, mask, s).reshape(1, Ts, -1)
    x = x + _proj(attn, lp, spec, mm)
    x = x + ffn(lp, norm(x, lp["ln2_w"], lp.get("ln2_b")))
    return x, pool_k, pool_v


def _check_device(x, what: str):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def decode_block(x, lp, pool_k, pool_v, block_table, lengths, cos, sin, *,
                 spec: DecodeBlockSpec):
    """One Llama or GPT layer for one decode token per sequence.

    ``x``: [B, H] residual stream; ``lp``: the layer's weights
    (``models.llama.block_shapes`` or ``models.gpt.block_shapes`` keys,
    ``[in, out]``; a quantized spec's ``<name>__q`` / ``<name>__s`` for
    the matmuls); ``pool_k/v``: [NB, BS, Hkv, D] tensors or
    ``QuantizedKVPool`` s; ``block_table``: [B, MB] int32; ``lengths``:
    [B] tokens already stored; ``cos``/``sin``: [B, D], None for a layer
    without RoPE.  Returns ``(x_out, pool_k, pool_v)``
    with the new token's KV written in place.  CUDA tensors launch the
    kernel chain (or raise); CPU tensors run :func:`decode_block_ref`.

    A row whose current page is unmapped (an inactive slot: table all
    ``-1``, length 0) writes nothing and attends page 0's first row,
    as in the JAX package; the engine never reads such rows."""
    validate_paged_decode_geometry(
        (x.shape[0], spec.num_heads, spec.head_dim), pool_k, pool_v,
        block_table, lengths, op="decode_block")
    _check_device(x, "decode_block")
    if x.is_cuda:
        from .cuda.decode_block import decode_block_cuda
        return decode_block_cuda(x, lp, pool_k, pool_v, block_table,
                                 lengths, cos, sin, spec=spec)
    return decode_block_ref(x, lp, pool_k, pool_v, block_table, lengths,
                            cos, sin, spec=spec)


def prefill_block(x, lp, pool_k, pool_v, blk, off, bt_row, cos, sin, *,
                  spec: DecodeBlockSpec, start: int,
                  scale: Optional[float] = None):
    """One Llama or GPT layer for ``Ts`` prompt tokens of ONE sequence at
    absolute positions ``start + [0, Ts)`` — the chunked-prefill twin of
    :func:`decode_block`.  Arguments as :func:`prefill_block_ref`; row
    ``i`` sees pool positions ``<= start + i`` (the JAX op's ``mask``
    argument is always that mask in the engine, so both versions build
    it from ``start``)."""
    _check_device(x, "prefill_block")
    if x.is_cuda:
        from .cuda.prefill_block import prefill_block_cuda
        return prefill_block_cuda(x, lp, pool_k, pool_v, blk, off, bt_row,
                                  cos, sin, spec=spec, start=start,
                                  scale=scale)
    return prefill_block_ref(x, lp, pool_k, pool_v, blk, off, bt_row, cos,
                             sin, spec=spec, start=start, scale=scale)
