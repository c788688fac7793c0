"""The incubate fused layers as ``torch.nn.Module``s:
``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer``, ``FusedLinear``, ``FusedDropout``,
``FusedDropoutAdd`` and ``FusedBiasDropoutResidualLayerNorm``.

Counterparts of ``paddle_tpu/incubate/nn/layer.py:22-249``, with their
attribute names and shapes, so a JAX ``state_dict()`` loads through
``bridge.state_dict_from_numpy`` unchanged.  Parameters are fp32 (cast a
layer with ``.to(torch.bfloat16)``), drawn with the JAX layers'
distributions from ``generator`` (the default generator of ``device``
when None): weights Xavier-uniform over their 2-D shape, biases zero,
LayerNorm gains one.  ``device=None`` means CUDA.  Dropout masks come from
the same ``generator`` (keep it on the device the layer runs on).

What the layers run, as in JAX:

* ``FusedMultiHeadAttention``: [pre-LN, the jnp chain of
  ``nn.functional.layer_norm``] -> ``x @ qkv_weight + qkv_bias`` read as
  ``[b, s, H, 3 * D]`` and split on its last axis -> attention through
  ``nn.functional.scaled_dot_product_attention`` (flash without mask and
  dropout, else the dense chain) -> out product -> pre-LN:
  ``fused_dropout_add(out + linear_bias, residual)`` (kernel 19);
  post-LN: ``fused_bias_dropout_residual_layer_norm`` (kernel 14 in eval).
* ``FusedFeedForward``: [pre-LN] -> linear1 -> ``fused_bias_act`` (kernel
  18) -> dropout -> linear2 -> kernel 19 (pre-LN) or kernel 14 (post-LN).

The JAX layers read neither ``key`` / ``value`` nor ``cache`` (self-
attention only), nor ``kdim``, ``vdim`` or ``need_weights``; neither do
these.  A ``ParamAttr`` (``*_attr`` other than None, or ``False`` for a
bias where JAX allows it) and ``nranks`` / ``ring_id`` other than one
card raise ``NotImplementedError``.  ``FusedMultiTransformer`` and
``FusedTransformer`` are ROADMAP queue 1 item 19b, ``FusedEcMoe`` item 15.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...device import resolve_device
from ...nn import functional as F
from . import functional as IF

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedLinear", "FusedDropout",
           "FusedDropoutAdd", "FusedBiasDropoutResidualLayerNorm"]


def _refuse_attrs(layer: str, nranks: int = 1, ring_id: int = -1, **attrs):
    named = sorted(k for k, v in attrs.items() if v is not None)
    if named:
        raise NotImplementedError(
            f"{layer}: ParamAttr arguments ({', '.join(named)}) are not "
            f"ported to paddle_tpu_torch yet (ROADMAP queue 1 item 20)")
    if nranks != 1 or ring_id not in (-1, None):
        raise NotImplementedError(
            f"{layer}: tensor parallelism (nranks, ring_id) is not ported "
            f"to paddle_tpu_torch yet (ROADMAP queue 1 item 17)")


class _Params:
    """Makes a layer's parameters on one device from one generator."""

    def __init__(self, generator, device):
        self.gen, self.dev = generator, resolve_device(device)

    def weight(self, *shape):
        limit = math.sqrt(6.0 / (shape[0] + shape[1]))
        return torch.nn.Parameter(torch.empty(shape, device=self.dev)
                                  .uniform_(-limit, limit,
                                            generator=self.gen))

    def zeros(self, n):
        return torch.nn.Parameter(torch.zeros(n, device=self.dev))

    def ones(self, n):
        return torch.nn.Parameter(torch.ones(n, device=self.dev))


class FusedMultiHeadAttention(torch.nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 dropout_rate: float = 0.5, attn_dropout_rate: float = 0.5,
                 kdim=None, vdim=None, normalize_before: bool = False,
                 need_weights: bool = False, qkv_weight_attr=None,
                 qkv_bias_attr=None, linear_weight_attr=None,
                 linear_bias_attr=None, pre_ln_scale_attr=None,
                 pre_ln_bias_attr=None, ln_scale_attr=None,
                 ln_bias_attr=None, epsilon: float = 1e-5, nranks: int = 1,
                 ring_id: int = -1, name=None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _refuse_attrs("FusedMultiHeadAttention", nranks, ring_id,
                      qkv_weight_attr=qkv_weight_attr,
                      qkv_bias_attr=qkv_bias_attr,
                      linear_weight_attr=linear_weight_attr,
                      linear_bias_attr=linear_bias_attr,
                      pre_ln_scale_attr=pre_ln_scale_attr,
                      pre_ln_bias_attr=pre_ln_bias_attr,
                      ln_scale_attr=ln_scale_attr, ln_bias_attr=ln_bias_attr)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate, self.attn_dropout_rate = dropout_rate, \
            attn_dropout_rate
        self.epsilon, self.generator = epsilon, generator
        mk = _Params(generator, device)
        self.qkv_weight = mk.weight(embed_dim, 3 * embed_dim)
        self.qkv_bias = mk.zeros(3 * embed_dim)
        self.linear_weight = mk.weight(embed_dim, embed_dim)
        self.linear_bias = mk.zeros(embed_dim)
        self.pre_ln_scale = mk.ones(embed_dim)
        self.pre_ln_bias = mk.zeros(embed_dim)
        self.ln_scale = mk.ones(embed_dim)
        self.ln_bias = mk.zeros(embed_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        x = residual = query
        if self.normalize_before:
            x = F.layer_norm(x, (self.embed_dim,), self.pre_ln_scale,
                             self.pre_ln_bias, self.epsilon)
        b, s = x.shape[0], x.shape[1]
        qkv = (x @ self.qkv_weight + self.qkv_bias).reshape(
            b, s, self.num_heads, 3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)
        attn = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_dropout_rate,
            training=self.training, generator=self.generator)
        out = attn.reshape(b, s, self.embed_dim) @ self.linear_weight
        if self.normalize_before:
            return IF.fused_dropout_add(out + self.linear_bias, residual,
                                        p=self.dropout_rate,
                                        training=self.training,
                                        generator=self.generator)
        return IF.fused_bias_dropout_residual_layer_norm(
            out, residual, self.linear_bias, self.ln_scale, self.ln_bias,
            dropout_rate=self.dropout_rate, ln_epsilon=self.epsilon,
            training=self.training, generator=self.generator)

    def extra_repr(self):
        return (f"embed_dim={self.embed_dim}, num_heads={self.num_heads}, "
                f"normalize_before={self.normalize_before}")


class FusedFeedForward(torch.nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout_rate: float = 0.1, epsilon: float = 1e-5,
                 activation: str = "relu", act_dropout_rate=None,
                 normalize_before: bool = False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks: int = 1, ring_id: int = -1,
                 name=None, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        _refuse_attrs("FusedFeedForward", nranks, ring_id,
                      linear1_weight_attr=linear1_weight_attr,
                      linear1_bias_attr=linear1_bias_attr,
                      linear2_weight_attr=linear2_weight_attr,
                      linear2_bias_attr=linear2_bias_attr,
                      ln1_scale_attr=ln1_scale_attr,
                      ln1_bias_attr=ln1_bias_attr,
                      ln2_scale_attr=ln2_scale_attr,
                      ln2_bias_attr=ln2_bias_attr)
        self.d_model = d_model
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                 else act_dropout_rate)
        self.activation, self.epsilon = activation, epsilon
        self.generator = generator
        mk = _Params(generator, device)
        self.linear1_weight = mk.weight(d_model, dim_feedforward)
        self.linear1_bias = mk.zeros(dim_feedforward)
        self.linear2_weight = mk.weight(dim_feedforward, d_model)
        self.linear2_bias = mk.zeros(d_model)
        self.ln1_scale = mk.ones(d_model)
        self.ln1_bias = mk.zeros(d_model)
        self.ln2_scale = mk.ones(d_model)
        self.ln2_bias = mk.zeros(d_model)

    def forward(self, src, cache=None):
        x = residual = src
        if self.normalize_before:
            x = F.layer_norm(x, (self.d_model,), self.ln1_scale,
                             self.ln1_bias, self.epsilon)
        h = IF.fused_bias_act(x @ self.linear1_weight, self.linear1_bias,
                              act_method=self.activation)
        h = F.dropout(h, self.act_dropout_rate, training=self.training,
                      generator=self.generator)
        out = h @ self.linear2_weight
        if self.normalize_before:
            return IF.fused_dropout_add(out + self.linear2_bias, residual,
                                        p=self.dropout_rate,
                                        training=self.training,
                                        generator=self.generator)
        return IF.fused_bias_dropout_residual_layer_norm(
            out, residual, self.linear2_bias, self.ln2_scale, self.ln2_bias,
            dropout_rate=self.dropout_rate, ln_epsilon=self.epsilon,
            training=self.training, generator=self.generator)

    def extra_repr(self):
        return (f"d_model={self.d_model}, activation={self.activation}, "
                f"normalize_before={self.normalize_before}")


class FusedTransformerEncoderLayer(torch.nn.Module):
    """``FusedFeedForward(FusedMultiHeadAttention(src))``; the attention's
    dropout defaults to ``dropout_rate``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout_rate: float = 0.1, activation: str = "relu",
                 attn_dropout_rate=None, act_dropout_rate=None,
                 normalize_before: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                             else attn_dropout_rate)
        kw = dict(generator=generator, device=device)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedLinear(torch.nn.Module):
    """``x @ weight + bias`` through ``fused_linear``; ``weight`` is
    ``[in, out]``, or ``[out, in]`` with ``transpose_weight``."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None,
                 transpose_weight: bool = False, name=None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _refuse_attrs("FusedLinear", weight_attr=weight_attr,
                      bias_attr=None if bias_attr is False else bias_attr)
        self.transpose_weight = transpose_weight
        mk = _Params(generator, device)
        self.weight = mk.weight(*((out_features, in_features)
                                  if transpose_weight
                                  else (in_features, out_features)))
        self.bias = None if bias_attr is False else mk.zeros(out_features)

    def forward(self, x):
        return IF.fused_linear(x, self.weight, self.bias,
                               transpose_weight=self.transpose_weight)


class FusedDropout(torch.nn.Module):
    """``nn.functional.dropout`` in training mode, the identity in eval;
    ``axis`` and the ``downscale_in_infer`` mode raise (ROADMAP queue 1
    item 17)."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if axis is not None or mode != "upscale_in_train":
            raise NotImplementedError(
                "FusedDropout: dropout's axis and mode are not ported to "
                "paddle_tpu_torch yet (ROADMAP queue 1 item 17)")
        self.p, self.generator = p, generator

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training,
                         generator=self.generator)


class FusedDropoutAdd(torch.nn.Module):
    """``dropout(x) + y`` through ``fused_dropout_add`` (kernel 19); like
    the JAX layer it hands ``mode`` to a call that drops it."""

    def __init__(self, p: float = 0.5, mode: str = "upscale_in_train",
                 name=None, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.mode, self.generator = p, mode, generator

    def forward(self, x, y):
        return IF.fused_dropout_add(x, y, self.p, training=self.training,
                                    mode=self.mode, generator=self.generator)


class FusedBiasDropoutResidualLayerNorm(torch.nn.Module):
    """``LayerNorm(residual + dropout(x + linear_bias))``;
    ``bias_attr=False`` drops the bias, as in JAX."""

    def __init__(self, embed_dim: int, dropout_rate: float = 0.5,
                 weight_attr=None, bias_attr=None, epsilon: float = 1e-5,
                 name=None, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        _refuse_attrs("FusedBiasDropoutResidualLayerNorm",
                      weight_attr=weight_attr,
                      bias_attr=None if bias_attr is False else bias_attr)
        self.p, self.epsilon, self.generator = dropout_rate, epsilon, \
            generator
        mk = _Params(generator, device)
        self.linear_bias = None if bias_attr is False else \
            mk.zeros(embed_dim)
        self.ln_scale = mk.ones(embed_dim)
        self.ln_bias = mk.zeros(embed_dim)

    def forward(self, x, residual):
        return IF.fused_bias_dropout_residual_layer_norm(
            x, residual, self.linear_bias, self.ln_scale, self.ln_bias,
            dropout_rate=self.p, ln_epsilon=self.epsilon,
            training=self.training, generator=self.generator)
