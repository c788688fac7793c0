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
  dropout).

Dropout masks come from the ``generator`` argument (the default generator
of the tensor's device when None); the JAX package draws from its global
key, so masks agree in distribution, not in bits.  The MMHA calls
(``masked_multihead_attention``, ``fused_multi_transformer``,
``block_multihead_attention``) are ROADMAP queue 1 item 19b.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...nn import functional as F
from ...ops import fused as _fused
from ...ops import norms as _norms
from ...ops import rope as _rope

__all__ = ["fused_rms_norm", "fused_layer_norm",
           "fused_bias_dropout_residual_layer_norm",
           "fused_rotary_position_embedding", "fused_bias_act",
           "fused_dropout_add", "swiglu", "fused_linear",
           "fused_matmul_bias", "fused_linear_activation",
           "fused_multi_head_attention", "fused_feedforward"]


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
        _refuse("fused_multi_head_attention with cache_kv (decode goes "
                "through masked_multihead_attention)", "item 19b")
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
