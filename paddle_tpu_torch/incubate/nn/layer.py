"""The incubate fused layers as ``torch.nn.Module``s:
``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer``, ``FusedLinear``, ``FusedDropout``,
``FusedDropoutAdd``, ``FusedBiasDropoutResidualLayerNorm``,
``FusedMultiTransformer`` and ``FusedTransformer``.

Counterparts of ``paddle_tpu/incubate/nn/layer.py:22-249`` and
``:276-406``, with their attribute names and shapes, so a JAX
``state_dict()`` loads through ``bridge.state_dict_from_numpy``
unchanged.  Parameters are fp32 (cast a layer with
``.to(torch.bfloat16)``), drawn with the JAX layers' distributions from
``generator`` (the default generator of ``device`` when None): weights
Xavier-uniform (a 4-D weight's fans as JAX's ``initializer._fans`` takes
them), biases zero, LayerNorm gains one.  ``device=None`` means CUDA.
Dropout masks come from the same ``generator`` (keep it on the device
the layer runs on).

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
* ``FusedMultiTransformer``: the whole serving stack through
  ``fused_multi_transformer`` (flash for the context, kernel 3 for the
  decode steps), its parameters named as JAX's (``ln_s_<i>``,
  ``qkvw_<i>``, ..., ``f2b_<i>``).
* ``FusedTransformer``: a stack of ``FusedTransformerEncoderLayer``
  (``layers.<i>``) with JAX's defaults (dropout 0.1, GELU).

The JAX layers read neither ``key`` / ``value`` nor ``cache`` (self-
attention only), nor ``kdim``, ``vdim`` or ``need_weights``; neither do
these.  A ``ParamAttr`` (``*_attr`` other than None, or ``False`` for a
bias where JAX allows it) and ``nranks`` / ``ring_id`` other than one
card raise ``NotImplementedError``.  ``FusedEcMoe`` is ROADMAP queue 1
item 15b.
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
           "FusedDropoutAdd", "FusedBiasDropoutResidualLayerNorm",
           "FusedMultiTransformer", "FusedTransformer"]


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
        # JAX's fans: [in, out], or [out, in, *rest] as a conv kernel's
        rest = math.prod(shape[2:])
        fan_in, fan_out = (shape if len(shape) == 2
                           else (shape[1] * rest, shape[0] * rest))
        limit = math.sqrt(6.0 / (fan_in + fan_out))
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


#: FusedMultiTransformer's per-layer parameters: JAX's names, then the
#: ``fused_multi_transformer`` argument each list goes to
_FMT_PARAMS = (("ln_s", "ln_scales"), ("ln_b", "ln_biases"),
               ("qkvw", "qkv_weights"), ("qkvb", "qkv_biases"),
               ("lw", "linear_weights"), ("lb", "linear_biases"),
               ("flns", "ffn_ln_scales"), ("flnb", "ffn_ln_biases"),
               ("f1w", "ffn1_weights"), ("f1b", "ffn1_biases"),
               ("f2w", "ffn2_weights"), ("f2b", "ffn2_biases"))


class FusedMultiTransformer(torch.nn.Module):
    """The serving stack of ``num_layers`` blocks over
    ``fused_multi_transformer``: ``forward(x, attn_mask, caches,
    time_step, rotary_embs)`` runs the context phase (``time_step``
    None) or one decode step, writing ``caches`` (``[2, B, H, T_max, D]``
    per layer) in place.  ``qkvw_<i>`` is ``[3, H, D, E]``, or ``[E, 3, H,
    D]`` when ``trans_qkvw`` is false."""

    def __init__(self, embed_dim: int, num_heads: int, dim_feedforward: int,
                 dropout_rate: float = 0.0, activation: str = "gelu",
                 normalize_before: bool = True, ln_scale_attrs=None,
                 ln_bias_attrs=None, qkv_weight_attrs=None,
                 qkv_bias_attrs=None, linear_weight_attrs=None,
                 linear_bias_attrs=None, ffn_ln_scale_attrs=None,
                 ffn_ln_bias_attrs=None, ffn1_weight_attrs=None,
                 ffn1_bias_attrs=None, ffn2_weight_attrs=None,
                 ffn2_bias_attrs=None, epsilon: float = 1e-5,
                 num_layers: int = -1, nranks: int = 1,
                 trans_qkvw: bool = True, ring_id: int = -1, name=None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _refuse_attrs("FusedMultiTransformer", nranks, ring_id,
                      ln_scale_attrs=ln_scale_attrs,
                      ln_bias_attrs=ln_bias_attrs,
                      qkv_weight_attrs=qkv_weight_attrs,
                      qkv_bias_attrs=qkv_bias_attrs,
                      linear_weight_attrs=linear_weight_attrs,
                      linear_bias_attrs=linear_bias_attrs,
                      ffn_ln_scale_attrs=ffn_ln_scale_attrs,
                      ffn_ln_bias_attrs=ffn_ln_bias_attrs,
                      ffn1_weight_attrs=ffn1_weight_attrs,
                      ffn1_bias_attrs=ffn1_bias_attrs,
                      ffn2_weight_attrs=ffn2_weight_attrs,
                      ffn2_bias_attrs=ffn2_bias_attrs)
        self.num_layers = num_layers if num_layers >= 0 else 1
        self.dropout_rate, self.activation = dropout_rate, activation
        self.normalize_before, self.epsilon = normalize_before, epsilon
        self.trans_qkvw = trans_qkvw
        E, F_, H = embed_dim, dim_feedforward, num_heads
        D = E // H
        mk = _Params(generator, device)
        for i in range(self.num_layers):
            for name_, p in (
                    ("ln_s", mk.ones(E)), ("ln_b", mk.zeros(E)),
                    ("qkvw", mk.weight(*((3, H, D, E) if trans_qkvw
                                         else (E, 3, H, D)))),
                    ("qkvb", torch.nn.Parameter(torch.zeros(
                        3, H, D, device=mk.dev))),
                    ("lw", mk.weight(E, E)), ("lb", mk.zeros(E)),
                    ("flns", mk.ones(E)), ("flnb", mk.zeros(E)),
                    ("f1w", mk.weight(E, F_)), ("f1b", mk.zeros(F_)),
                    ("f2w", mk.weight(F_, E)), ("f2b", mk.zeros(E))):
                self.register_parameter(f"{name_}_{i}", p)

    def forward(self, x, attn_mask=None, caches=None, time_step=None,
                rotary_embs=None):
        lists = {arg: [getattr(self, f"{name_}_{i}")
                       for i in range(self.num_layers)]
                 for name_, arg in _FMT_PARAMS}
        return IF.fused_multi_transformer(
            x, **lists, pre_layer_norm=self.normalize_before,
            epsilon=self.epsilon, cache_kvs=caches, time_step=time_step,
            attn_mask=attn_mask, rotary_embs=rotary_embs,
            activation=self.activation, dropout_rate=self.dropout_rate,
            training=self.training, trans_qkvw=self.trans_qkvw)

    def extra_repr(self):
        return (f"num_layers={self.num_layers}, "
                f"normalize_before={self.normalize_before}, "
                f"activation={self.activation}")


class FusedTransformer(torch.nn.Module):
    """An encoder stack of ``num_encoder_layers``
    ``FusedTransformerEncoderLayer``s, each with ``src_mask``."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: str = "gelu", name=None,
                 *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            FusedTransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout,
                activation=activation, generator=generator, device=device)
            for _ in range(num_encoder_layers))

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        return out
