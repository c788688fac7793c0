"""The incubate fused functional API.

Counterpart of ``paddle_tpu/incubate/nn/functional/__init__.py``, over
:mod:`...ops.norms`, :mod:`...ops.rope` and :mod:`...ops.fused` (the
kernels on the card, their plain versions on the CPU):

* ``fused_rms_norm`` (:27-39), ``fused_layer_norm`` (:42-52) and
  ``fused_bias_dropout_residual_layer_norm`` (:55-69), kernels 12-14;
* ``fused_rotary_position_embedding`` (:72-78), kernel 15;
* ``fused_bias_act`` (:81-84), kernel 18 (``"swiglu"``: kernel 16);
* ``fused_dropout_add`` (:87-95), kernel 19;
* ``swiglu`` (:98-104), kernel 16;
* ``fused_linear``, ``fused_matmul_bias`` and ``fused_linear_activation``
  (:107-126, :719-728): a torch product, then the bias (or kernel 18);
* ``fused_multi_head_attention`` (:129-216) and ``fused_feedforward``
  (:731-792): jnp chains in JAX, torch-op chains here, attention through
  ``nn.functional.scaled_dot_product_attention`` (flash without mask and
  dropout);
* the serving calls, each a torch-op chain around one attention kernel:
  ``masked_multihead_attention`` (:219-424, one decode step over Paddle's
  head-major cache ``[2, B, H, T_max, D]``: kernel 3 on the view
  ``cache_kv[0].transpose(1, 2)``, read in place through its head
  stride), ``fused_multi_transformer`` (:427-627: the context phase
  through flash, kernel 6; the decode phase through kernel 3 on the same
  view), ``block_multihead_attention`` and ``blha_get_max_len``
  (:795-833, over :mod:`...ops.paged_kv`, a torch chain on both devices
  as JAX's is jnp);
* ``fused_adam`` (:663-716): per-tensor Adam / AdamW in torch ops.

Dropout masks come from the ``generator`` argument (the default generator
of the tensor's device when None); the JAX package draws from its global
key, so masks agree in distribution, not in bits.

One documented divergence: ``masked_multihead_attention`` and
``fused_multi_transformer`` write this step's k / v into the caller's
caches IN PLACE and return those tensors, as Paddle's ops do (the JAX
functions return new arrays and leave their inputs unchanged); the values
returned are JAX's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...nn import functional as F
from ...ops import fused as _fused
from ...ops import norms as _norms
from ...ops import rope as _rope
from ...ops.decode_attention import decode_attention
from ...ops.decode_block import rotate_half
from ...ops.paged_kv import paged_append, paged_decode_attention

__all__ = ["fused_rms_norm", "fused_layer_norm",
           "fused_bias_dropout_residual_layer_norm",
           "fused_rotary_position_embedding", "fused_bias_act",
           "fused_dropout_add", "swiglu", "fused_linear",
           "fused_matmul_bias", "fused_linear_activation",
           "fused_multi_head_attention", "fused_feedforward",
           "masked_multihead_attention", "fused_multi_transformer",
           "fused_adam", "blha_get_max_len", "block_multihead_attention"]


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon: float = 1e-6,
                   begin_norm_axis: int = -1, bias=None, residual=None):
    """``rms_norm(x + bias + residual) * w + norm_bias`` over the last axis
    (as the JAX op, whatever ``begin_norm_axis`` says).  With a
    ``residual`` returns ``(out, x + bias + residual)``."""
    if bias is not None:
        x = x + bias
    if residual is not None:
        x = x + residual
    out = _norms.rms_norm(x, norm_weight, epsilon)
    if norm_bias is not None:
        out = out + norm_bias
    return (out, x) if residual is not None else out


def fused_layer_norm(x, norm_weight, norm_bias, epsilon: float = 1e-5,
                     begin_norm_axis: int = -1, bias=None, residual=None):
    """``layer_norm(x + bias + residual)`` over the last axis through the
    fused LayerNorm (kernel 13).  With a ``residual`` returns ``(out,
    x + bias + residual)``."""
    if bias is not None:
        x = x + bias
    if residual is not None:
        x = x + residual
    out = _norms.layer_norm(x, norm_weight, norm_bias, epsilon)
    return (out, x) if residual is not None else out


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate: float = 0.5, ln_epsilon: float = 1e-5,
        training: bool = False, generator: Optional[torch.Generator] = None):
    """``LayerNorm(residual + dropout(x + bias))`` (kernel 14 at p = 0 or in
    eval; the composed chain with a ``generator`` mask in training).  A
    missing bias is zero in x's dtype, a missing ``ln_scale`` one and
    ``ln_bias`` zero in fp32, as in JAX."""
    H, dev = x.shape[-1], x.device
    if bias is None:
        bias = torch.zeros(H, dtype=x.dtype, device=dev)
    if ln_scale is None:
        ln_scale = torch.ones(H, dtype=torch.float32, device=dev)
    if ln_bias is None:
        ln_bias = torch.zeros(H, dtype=torch.float32, device=dev)
    out, _ = _norms.fused_bias_dropout_residual_layer_norm(
        x, residual, bias, ln_scale, ln_bias, dropout_rate, ln_epsilon,
        training, generator)
    return out


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style: bool = True):
    """``(q, k, v)`` with rotate-half RoPE on q and k (kernel 15; v passes
    through).  ``use_neox_rotary_style`` is ignored, as in JAX."""
    return _rope.fused_rope(q, k, v, sin, cos, position_ids,
                            use_neox_rotary_style)


def fused_bias_act(x, bias, act_method: str = "gelu"):
    """``act(x + bias)`` (kernel 18; ``"swiglu"`` through kernel 16)."""
    return _fused.fused_bias_act(x, bias, act_method)


def fused_dropout_add(x, y, p: float = 0.5, training: bool = True,
                      mode: str = "upscale_in_train", name=None,
                      generator: Optional[torch.Generator] = None):
    """``dropout(x) + y`` (kernel 19), the seed drawn from ``generator``.
    ``mode`` is dropped, as the JAX wrapper drops it: a
    ``downscale_in_infer`` caller gets ``upscale_in_train``."""
    return _fused.fused_dropout_add(x, y, p, training, generator=generator)


def swiglu(x, y=None):
    """``silu(x) * y``; with one argument, x's last axis splits into the
    two halves ``x[..., :h]`` and ``x[..., h:]``."""
    if y is None:
        h = x.shape[-1] // 2
        x, y = x[..., :h], x[..., h:]
    return _fused.swiglu(x, y)


def fused_linear(x, weight, bias=None, transpose_weight: bool = False):
    """``x @ weight + bias`` (``weight`` ``[in, out]``, or ``[out, in]``
    with ``transpose_weight``)."""
    if transpose_weight:
        weight = weight.transpose(-2, -1)
    out = x @ weight
    return out if bias is None else out + bias


def fused_matmul_bias(x, y, bias=None, transpose_x: bool = False,
                      transpose_y: bool = False, name=None):
    """``x @ y + bias`` with either operand transposed on its last two
    axes."""
    a = x.transpose(-1, -2) if transpose_x else x
    w = y.transpose(-1, -2) if transpose_y else y
    out = a @ w
    return out if bias is None else out + bias


def fused_linear_activation(x, y, bias, trans_x: bool = False,
                            trans_y: bool = False,
                            activation: str = "gelu"):
    """``act(x @ y + bias)``: the product, then kernel 18."""
    if trans_x:
        x = x.transpose(-2, -1)
    if trans_y:
        y = y.transpose(-2, -1)
    return _fused.fused_bias_act(x @ y, bias, activation)


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to paddle_tpu_torch yet "
                              f"(ROADMAP queue 1 {item})")


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm: bool = False,
                               pre_ln_scale=None, pre_ln_bias=None,
                               ln_scale=None, ln_bias=None,
                               pre_ln_epsilon: float = 1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate: float = 0.0,
                               attn_dropout_rate: float = 0.0,
                               ln_epsilon: float = 1e-5,
                               training: bool = True,
                               mode: str = "upscale_in_train",
                               ring_id: int = -1, add_residual: bool = True,
                               num_heads: int = -1,
                               transpose_qkv_wb: bool = False, name=None,
                               generator: Optional[torch.Generator] = None):
    """The monolithic attention block of the JAX op: [pre-LN ->] the fused
    QKV product -> attention -> out product -> dropout -> [+ residual ->]
    [post-LN].  ``qkv_weight`` is ``[3, H, D, E]`` (Paddle's layout), or
    ``[E, 3 * E]`` with ``transpose_qkv_wb`` (then ``num_heads`` heads, and
    ``qkv_bias`` ``[3 * E]``).  Both LayerNorms are the jnp chain of
    ``nn.functional.layer_norm``."""
    if cache_kv is not None:
        raise NotImplementedError(
            "fused_multi_head_attention: decode with cache_kv goes through "
            "masked_multihead_attention / models.generation")
    if ring_id not in (-1, None):
        _refuse("fused_multi_head_attention over a tensor-parallel ring_id",
                "item 17")
    if mode != "upscale_in_train":
        raise NotImplementedError(
            f"fused_multi_head_attention: dropout mode {mode!r} (the JAX op "
            f"takes upscale_in_train only)")
    B, S, E = x.shape
    if transpose_qkv_wb:
        nh = num_heads
        qkvw = qkv_weight.reshape(E, 3, nh, E // nh).permute(1, 2, 3, 0)
        if qkv_bias is not None:
            qkv_bias = qkv_bias.reshape(3, nh, E // nh)
    else:
        qkvw, nh = qkv_weight, qkv_weight.shape[1]
    hd = qkvw.shape[2]
    y = x
    if pre_layer_norm:
        y = F.layer_norm(y, (E,), pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    qkv = torch.einsum("bse,thde->bsthd", y, qkvw)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias[None, None]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    attn = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0, is_causal=False,
        training=training, generator=generator)
    out = attn.reshape(B, S, nh * hd) @ linear_weight
    if linear_bias is not None:
        out = out + linear_bias
    out = F.dropout(out, dropout_rate, training, generator)
    if add_residual:
        out = x + out
    if not pre_layer_norm:
        out = F.layer_norm(out, (E,), ln_scale, ln_bias, ln_epsilon)
    return out


def _ffn_ln(v, scale, b, eps):
    """``fused_feedforward``'s LayerNorm chain: mean and the mean of the
    squared deviations, each summed in fp32 and rounded to v's dtype."""
    mu = v.float().mean(-1, keepdim=True).to(v.dtype)
    var = ((v - mu) ** 2).float().mean(-1, keepdim=True).to(v.dtype)
    out = (v - mu) * F.rsqrt_rounded(var + eps)
    if scale is not None:
        out = out * scale
    return out if b is None else out + b


_FFN_ACTS = {"relu": torch.relu, "gelu": _fused._ACTS["gelu"]}


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None,
                      dropout1_rate: float = 0.5, dropout2_rate: float = 0.5,
                      activation: str = "relu", ln1_epsilon: float = 1e-5,
                      ln2_epsilon: float = 1e-5,
                      pre_layer_norm: bool = False, training: bool = True,
                      mode: str = "upscale_in_train", ring_id: int = -1,
                      add_residual: bool = True, name=None,
                      generator: Optional[torch.Generator] = None):
    """The FFN block of the JAX op: [pre-LN ->] linear1 -> act (relu, or
    the tanh GELU) -> dropout -> linear2 -> dropout -> [+ residual ->]
    [post-LN], in x's dtype.  Dropout follows ``mode``
    (``upscale_in_train`` scales kept values by ``1 / (1 - p)`` in
    training; ``downscale_in_infer`` keeps them as they are and scales by
    ``1 - p`` in eval)."""
    if ring_id not in (-1, None):
        _refuse("fused_feedforward over a tensor-parallel ring_id",
                "item 17")
    if activation not in _FFN_ACTS:
        raise ValueError(f"unsupported activation {activation!r}")

    def drop(v, rate):
        if rate == 0.0:
            return v
        if not training:
            return v * (1.0 - rate) if mode == "downscale_in_infer" else v
        keep = torch.rand(v.shape, generator=generator, device=v.device) \
            < 1.0 - rate
        kept = v / (1.0 - rate) if mode == "upscale_in_train" else v
        return torch.where(keep, kept, 0.0).to(v.dtype)

    h = _ffn_ln(x, ln1_scale, ln1_bias, ln1_epsilon) if pre_layer_norm \
        else x
    h = h @ linear1_weight
    if linear1_bias is not None:
        h = h + linear1_bias
    h = drop(_FFN_ACTS[activation](h), dropout1_rate)
    h = h @ linear2_weight
    if linear2_bias is not None:
        h = h + linear2_bias
    h = drop(h, dropout2_rate)
    out = x + h if add_residual else h
    if not pre_layer_norm:
        out = _ffn_ln(out, ln2_scale, ln2_bias, ln2_epsilon)
    return out.to(x.dtype)


# ------------------------------------------------------------ serving calls
def _mmha_rope(q, k, rot, lens, neox: bool, dims: int):
    """The MMHA kernel's rotary (JAX ``_apply_mmha_rope``, :285-331):
    ``rot`` packs a cos plane then a sin plane ``[2, B, S_rot, 1, D]``; a
    table of one row is the pre-gathered row, a longer one is read at each
    row's length (clipped).  Interleaved pairs, or with ``neox`` the half
    rotation within each of ``dims`` sections; fp32, cast back."""
    B, H, D = q.shape
    rot = rot.float()
    if rot.shape[0] != 2 or rot.numel() % (2 * B * D):
        raise ValueError(f"rotary_tensor must pack [2 (cos,sin), B, "
                         f"rotary_seq_len, 1, {D}]; got shape "
                         f"{tuple(rot.shape)}")
    table = rot.reshape(2, B, -1, D)
    if table.shape[2] == 1:
        table = table[:, :, 0]
    else:
        pos = lens.long().clamp(0, table.shape[2] - 1)
        table = table[:, torch.arange(B, device=rot.device), pos]
    cos, sin = table[0][:, None], table[1][:, None]          # [B, 1, D]

    def tr(t):
        tf = t.float()
        if not neox:
            x, y = tf[..., 0::2], tf[..., 1::2]
            x2 = x * cos[..., 0::2] - y * sin[..., 0::2]
            y2 = y * cos[..., 1::2] + x * sin[..., 1::2]
            out = torch.stack([x2, y2], -1).reshape(B, H, D)
        else:
            last = D // dims
            half = last // 2
            sec = tf.reshape(B, H, dims, last)
            cs, sn = cos.reshape(B, 1, dims, last), sin.reshape(B, 1, dims,
                                                                last)
            x, y = sec[..., :half], sec[..., half:]
            x2 = x * cs[..., :half] - y * sn[..., :half]
            y2 = y * cs[..., half:] + x * sn[..., half:]
            out = torch.cat([x2, y2], -1).reshape(B, H, D)
        return out.to(t.dtype)

    return tr(q), tr(k)


@torch.no_grad()
def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               sequence_lengths=None, rotary_tensor=None,
                               beam_cache_offset=None, qkv_out_scale=None,
                               out_shift=None, out_smooth=None,
                               seq_len: int = 1, rotary_emb_dims: int = 0,
                               use_neox_rotary_style: bool = False,
                               compute_dtype: str = "default",
                               out_scale=-1, quant_round_type: int = 1,
                               quant_max_bound: float = 127.0,
                               quant_min_bound: float = -127.0):
    """One decode step of fused-QKV attention over a preallocated cache.
    ``x`` ``[B, 3 H D]`` (int32 with ``qkv_out_scale``, dequantized per
    channel), ``cache_kv`` ``[2, B, H, T_max, D]``, ``sequence_lengths``
    ``[B]`` (each row's cached rows; this step's k / v go to that row).
    Returns ``(out [B, H D], cache_kv)`` (and ``beam_cache_offset`` when
    given); ``out`` is int8 when ``out_scale > 0``, else in the cache's
    dtype.  With ``src_mask`` or beam offsets the attention is the dense
    masked chain (torch ops, as it is jnp in JAX); otherwise kernel 3 on
    the head-major view of the cache with ``lengths + 1``.  The cache is
    written IN PLACE and returned (Paddle's contract; the JAX function
    returns a new array)."""
    if rotary_tensor is not None and not rotary_emb_dims:
        rotary_emb_dims = 1
    if rotary_emb_dims and rotary_tensor is None:
        raise ValueError("masked_multihead_attention: rotary_emb_dims set "
                         "but rotary_tensor is None")
    if rotary_emb_dims not in (0, 1, 2):
        raise ValueError(f"rotary_emb_dims must be 0/1/2, got "
                         f"{rotary_emb_dims}")
    if beam_cache_offset is not None and cache_kv is None:
        raise ValueError("masked_multihead_attention: beam_cache_offset "
                         "requires cache_kv")
    if (out_shift is None) != (out_smooth is None):
        raise ValueError("masked_multihead_attention: out_shift and "
                         "out_smooth must be provided together (the "
                         "reference store applies (out+shift)*smooth)")
    quant_out = out_scale is not None and out_scale > 0
    if beam_cache_offset is not None:
        bo = beam_cache_offset
        if bo.ndim != 3 or bo.shape[0] * bo.shape[1] != cache_kv.shape[1]:
            raise ValueError(
                "beam_cache_offset must be [batch, beam_size, "
                "max_seq_len + max_dec_len] with batch*beam_size == "
                f"cache rows; got {tuple(bo.shape)} vs cache "
                f"{tuple(cache_kv.shape)}")
        if bo.shape[-1] != cache_kv.shape[3]:
            raise ValueError(
                "beam_cache_offset last dim must equal the cache "
                f"capacity (cache_kv.shape[3] == {cache_kv.shape[3]}); got "
                f"{bo.shape[-1]}")
    if sequence_lengths is not None and cache_kv is not None:
        mx = int(torch.as_tensor(sequence_lengths).max())
        if mx >= cache_kv.shape[3]:
            raise ValueError(f"masked_multihead_attention: cache full "
                             f"(length {mx} >= capacity "
                             f"{cache_kv.shape[3]})")
    if cache_kv is None:
        raise ValueError("masked_multihead_attention needs cache_kv "
                         "[2, B, H, T_max, D]")

    B = x.shape[0]
    H, T, D = cache_kv.shape[2], cache_kv.shape[3], cache_kv.shape[4]
    dev = cache_kv.device
    xv = x
    if qkv_out_scale is not None:
        xv = xv.float() * qkv_out_scale.float().reshape(-1)[None, :]
    if bias is not None:
        xv = xv + bias
    q, k, v = xv.reshape(B, 3, H, D).unbind(1)
    if sequence_lengths is None:
        raise ValueError("masked_multihead_attention needs "
                         "sequence_lengths (cache fill per row)")
    lens = sequence_lengths.reshape(B).to(device=dev, dtype=torch.int32)
    if rotary_tensor is not None:
        q, k = _mmha_rope(q, k, rotary_tensor, lens, use_neox_rotary_style,
                          rotary_emb_dims)
    # this step's k / v at each row's length, into the caller's cache
    bidx = torch.arange(B, device=dev)
    pos = lens.long()
    kc, vc = cache_kv[0], cache_kv[1]                    # [B, H, T, D]
    kc[bidx, :, pos] = k.to(cache_kv.dtype)
    vc[bidx, :, pos] = v.to(cache_kv.dtype)
    if src_mask is not None or beam_cache_offset is not None:
        if beam_cache_offset is not None:
            bw = beam_cache_offset.shape[1]
            off = beam_cache_offset.reshape(B, -1)[:, :T].to(dev).long()
            src = (bidx[:, None] // bw) * bw + off              # [B, T]
            # offsets cover past positions; this step reads its own row
            src[bidx, pos] = bidx
            tt = torch.arange(T, device=dev)[None, :]
            kd = kc[src, :, tt].transpose(1, 2)                 # [B, H, T, D]
            vd = vc[src, :, tt].transpose(1, 2)
        else:
            kd, vd = kc, vc
        scores = torch.einsum("bhd,bhtd->bht", q.float(), kd.float()) \
            * (D ** -0.5)
        if src_mask is not None:
            m = src_mask.float().reshape(B, 1, -1)
            if m.shape[-1] < T:
                m = torch.nn.functional.pad(m, (0, T - m.shape[-1]))
            scores = scores + m[..., :T]
        valid = torch.arange(T, device=dev)[None, None, :] \
            <= pos[:, None, None]
        scores = torch.where(valid, scores, -math.inf)
        probs = torch.softmax(scores, -1)
        out = torch.einsum("bht,bhtd->bhd", probs, vd.float())
    else:
        out = decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                               lens + 1)
    out = out.reshape(B, H * D)
    if out_shift is not None:
        out = (out.float() + out_shift.float().reshape(-1)[None, :]) \
            * out_smooth.float().reshape(-1)[None, :]
    if quant_out:
        qv = quant_max_bound * out_scale * out.float()
        qv = torch.round(qv) if quant_round_type == 0 else \
            torch.sign(qv) * torch.floor(qv.abs() + 0.5)
        out = qv.clamp(quant_min_bound, quant_max_bound).to(torch.int8)
    else:
        out = out.to(cache_kv.dtype)
    if beam_cache_offset is not None:
        return out, cache_kv, beam_cache_offset
    return out, cache_kv


#: ``getattr(jax.nn, activation)`` for the element-wise functions, with
#: jax.nn's defaults: ``"gelu"`` is the tanh approximation
_JAX_NN_ACTS = {
    "gelu": lambda h: torch.nn.functional.gelu(h, approximate="tanh"),
    "relu": torch.relu, "relu6": torch.nn.functional.relu6,
    "silu": torch.nn.functional.silu, "swish": torch.nn.functional.silu,
    "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "elu": torch.nn.functional.elu, "selu": torch.nn.functional.selu,
    "celu": torch.nn.functional.celu,
    "leaky_relu": torch.nn.functional.leaky_relu,
    "softplus": torch.nn.functional.softplus,
    "soft_sign": torch.nn.functional.softsign,
    "log_sigmoid": torch.nn.functional.logsigmoid,
    "hard_tanh": torch.nn.functional.hardtanh,
    "hard_sigmoid": torch.nn.functional.hardsigmoid,
    "hard_silu": torch.nn.functional.hardswish,
    "hard_swish": torch.nn.functional.hardswish,
    "mish": torch.nn.functional.mish, "identity": lambda h: h}


@torch.no_grad()
def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                            linear_weights, linear_biases, ffn_ln_scales,
                            ffn_ln_biases, ffn1_weights, ffn1_biases,
                            ffn2_weights, ffn2_biases,
                            pre_layer_norm: bool = True,
                            epsilon: float = 1e-5, cache_kvs=None,
                            pre_caches=None, rotary_embs=None,
                            time_step=None, attn_mask=None,
                            dropout_rate: float = 0.0,
                            rotary_emb_dims: int = 0,
                            activation: str = "gelu",
                            training: bool = False,
                            mode: str = "upscale_in_train",
                            trans_qkvw: bool = True, ring_id: int = -1,
                            name=None):
    """N pre- or post-LN blocks: [LN ->] fused QKV -> attention -> out
    product -> + residual -> [LN ->] ffn1 -> act -> ffn2 -> + residual.

    Context phase (``time_step`` None): causal attention through flash
    (kernel 6) without ``attn_mask`` and ``pre_caches``, else the dense
    chain; with ``cache_kvs`` (``[2, B, H, T_max, D]`` per layer) the
    prefix and this call's k / v fill rows ``[:P + S]`` of each cache.
    Decode phase (``time_step`` an int): one token a row at cache slot
    ``time_step + P`` (``P`` the ``pre_caches`` length, re-passed each
    step), RoPE at ``time_step``, attention through kernel 3 on the
    head-major view of each cache.  ``qkv_weights`` are ``[3, H, D, E]``
    (``trans_qkvw``) or ``[E, 3, H, D]``; ``rotary_embs`` ``[2, B, 1,
    S_max, D]`` (cos, sin; neox half rotation, its start clamped to
    ``S_max - S`` as ``jax.lax.dynamic_slice_in_dim`` clamps it).  The
    LayerNorms are the jnp chain of ``nn.functional.layer_norm``;
    ``activation`` is looked up as ``getattr(jax.nn, activation)`` is
    (``"gelu"``: the tanh approximation).  Returns ``y``, or ``(y,
    cache_kvs)`` with the caller's caches, written IN PLACE."""
    if dropout_rate and training:
        raise NotImplementedError(
            "fused_multi_transformer: training-mode dropout not "
            "implemented (the op is a serving path; reference defaults "
            "dropout_rate=0)")
    if activation not in _JAX_NN_ACTS:
        raise ValueError(f"fused_multi_transformer: activation "
                         f"{activation!r} is not an element-wise jax.nn "
                         f"function ({', '.join(sorted(_JAX_NN_ACTS))})")
    act = _JAX_NN_ACTS[activation]
    decode = time_step is not None
    t_step = int(time_step) if decode else None
    n_layers = len(qkv_weights)
    caches = list(cache_kvs) if cache_kvs is not None else None
    pres = list(pre_caches) if pre_caches is not None else None
    B, S, E = x.shape
    dev = x.device

    def ln(y, s, b):
        return F.layer_norm(y, (E,), s, b, epsilon)

    def mm(a, b):
        # jnp's promotion: a bf16 operand meets an fp32 one (q / k after
        # an fp32 rotary table) in fp32
        t = torch.promote_types(a.dtype, b.dtype)
        return a.to(t) @ b.to(t)

    cos = sin = None
    if rotary_embs is not None:
        rot = rotary_embs
        start = min(max(t_step if decode else 0, 0), rot.shape[3] - S)
        cos = rot[0][:, :, start:start + S][:, 0][:, :, None]   # [B, S, 1, D]
        sin = rot[1][:, :, start:start + S][:, 0][:, :, None]

    y = x
    for i in range(n_layers):
        w = qkv_weights[i]
        if trans_qkvw:
            H, D = w.shape[1], w.shape[2]
            w2 = w.reshape(3 * H * D, E).t()
        else:
            H, D = w.shape[2], w.shape[3]
            w2 = w.reshape(E, 3 * H * D)
        resid = y
        h = ln(y, ln_scales[i], ln_biases[i]) if pre_layer_norm else y
        qkv = mm(h, w2).reshape(B, S, 3, H, D)
        if qkv_biases[i] is not None:
            qkv = qkv + qkv_biases[i][None, None]
        q, k, v = qkv.unbind(2)                                # [B, S, H, D]
        if cos is not None:
            q = q * cos + rotate_half(q) * sin
            k = k * cos + rotate_half(k) * sin
        P = pres[i].shape[3] if pres is not None else 0
        if decode:
            slot = t_step + P
            kc, vc = caches[i][0], caches[i][1]                # [B, H, T, D]
            if not 0 <= slot < kc.shape[2]:
                raise ValueError(f"fused_multi_transformer: cache slot "
                                 f"{slot} (time_step {t_step} + prefix {P}) "
                                 f"outside the capacity {kc.shape[2]}")
            kc[:, :, slot] = k[:, 0]
            vc[:, :, slot] = v[:, 0]
            lens = torch.full((B,), slot + 1, dtype=torch.int32, device=dev)
            attn = decode_attention(q[:, 0], kc.transpose(1, 2),
                                    vc.transpose(1, 2), lens)[:, None]
        else:
            k_full, v_full, amask = k, v, attn_mask
            if pres is not None:
                pk, pv = pres[i][0].transpose(1, 2), pres[i][1].transpose(1,
                                                                          2)
                k_full = torch.cat([pk.to(k.dtype), k], 1)
                v_full = torch.cat([pv.to(v.dtype), v], 1)
                if amask is None:
                    # the prefix always visible, causal over this call
                    amask = torch.ones((S, P + S), dtype=torch.bool,
                                       device=dev).tril(P)[None, None]
                elif amask.shape[-1] == S:
                    band = (torch.ones if amask.dtype == torch.bool
                            else torch.zeros)(
                        (*amask.shape[:-1], P), dtype=amask.dtype,
                        device=amask.device)
                    amask = torch.cat([band, amask], -1)
            if caches is not None:
                n = k_full.shape[1]
                caches[i][0][:, :, :n] = k_full.transpose(1, 2)
                caches[i][1][:, :, :n] = v_full.transpose(1, 2)
            t = torch.promote_types(q.dtype, v_full.dtype)
            attn = F.scaled_dot_product_attention(
                q.to(t), k_full.to(t), v_full.to(t), attn_mask=amask,
                is_causal=amask is None, training=False)
        out = mm(attn.reshape(B, S, H * D), linear_weights[i])
        if linear_biases[i] is not None:
            out = out + linear_biases[i]
        y = resid + out
        if not pre_layer_norm:
            y = ln(y, ln_scales[i], ln_biases[i])
        resid = y
        h = ln(y, ffn_ln_scales[i], ffn_ln_biases[i]) if pre_layer_norm \
            else y
        h = mm(h, ffn1_weights[i])
        if ffn1_biases[i] is not None:
            h = h + ffn1_biases[i]
        h = mm(act(h), ffn2_weights[i])
        if ffn2_biases[i] is not None:
            h = h + ffn2_biases[i]
        y = resid + h
        if not pre_layer_norm:
            y = ln(y, ffn_ln_scales[i], ffn_ln_biases[i])
    return (y, caches) if caches is not None else y


def fused_adam(params, grads, lrs, moments1, moments2, beta1_pows,
               beta2_pows, master_weights=None, skip_update=None,
               beta1: float = 0.9, beta2: float = 0.999,
               epsilon: float = 1e-8, multi_precision: bool = False,
               use_adamw: bool = False, weight_decay: float = 0.01):
    """Adam / AdamW over lists of tensors, one tensor at a time, in fp32:
    ``beta1_pows`` / ``beta2_pows`` hold βᵗ (the bias correction divides
    by ``1 - pow``) and come back advanced by one factor; with
    ``master_weights`` the update runs on the fp32 master and the param
    gets the cast-down copy; ``skip_update[i]`` true passes tensor i
    through.  ``lrs`` and the pows are each a scalar or a list.  Returns
    new tensors ``(params, moments1, moments2, beta1_pows, beta2_pows,
    master_weights)`` (lists), as the JAX function does."""
    def pick(seq, i):
        return seq[i] if isinstance(seq, (list, tuple)) else seq

    outs = ([], [], [], [], [], [])
    for i, p in enumerate(params):
        mw = None if master_weights is None else master_weights[i]
        if skip_update is not None and bool(skip_update[i]):
            for acc, val in zip(outs, (p, moments1[i], moments2[i],
                                       pick(beta1_pows, i),
                                       pick(beta2_pows, i), mw)):
                acc.append(val)
            continue

        def f32(val):
            return torch.as_tensor(val, dtype=torch.float32, device=p.device)
        lr, b1p, b2p = (f32(pick(s, i)) for s in (lrs, beta1_pows,
                                                   beta2_pows))
        g32 = grads[i].float()
        work = mw if mw is not None else p.float()
        if use_adamw:
            work = work * (1.0 - lr * weight_decay)
        nm1 = beta1 * moments1[i] + (1 - beta1) * g32
        nm2 = beta2 * moments2[i] + (1 - beta2) * g32 * g32
        mhat = nm1 / (1 - b1p)
        vhat = nm2 / (1 - b2p)
        new_work = work - lr * mhat / (torch.sqrt(vhat) + epsilon)
        for acc, val in zip(outs, (new_work.to(p.dtype), nm1, nm2,
                                   b1p * beta1, b2p * beta2,
                                   new_work if mw is not None else None)):
            acc.append(val)
    return outs


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size=None,
                     name=None):
    """``(max encoder length, max decoder length)``."""
    return seq_lens_encoder.max(), seq_lens_decoder.max()


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time,
                              padding_offsets=None, cum_offsets=None,
                              cu_seqlens_q=None, cu_seqlens_k=None,
                              block_tables=None, *, max_seq_len=None,
                              block_size=None, use_neox_style: bool = False,
                              name=None, **kw):
    """One decode step over a paged pool: ``qkv`` ``[B, 3, H, D]`` (one
    new token a sequence), pools ``[NB, BS, H, D]``, ``block_tables``
    ``[B, MB]``.  Appends the new k / v at ``seq_lens_decoder`` through the
    tables (IN PLACE, as the port's pools are written), then the paged
    attention over ``seq_lens_decoder + 1`` rows.  Returns ``(out [B, H,
    D], key_cache, value_cache)``.  ``block_size`` wins over the pool's
    page size when given (JAX's precedence, :821-822)."""
    bs = block_size or key_cache.shape[1] if hasattr(
        key_cache, "shape") else block_size
    q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    kc, vc = paged_append(key_cache, value_cache, k_new, v_new, block_tables,
                          seq_lens_decoder, int(bs))
    out = paged_decode_attention(q, kc, vc, block_tables,
                                 seq_lens_decoder + 1)
    return out, kc, vc
