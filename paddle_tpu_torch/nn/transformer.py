"""Transformer layers: ``MultiHeadAttention``, the encoder and decoder
layers and stacks, and ``Transformer``, as ``torch.nn.Module``s.

Counterpart of ``paddle_tpu/nn/layer/transformer.py``, with its
arguments, defaults, checks and attribute names, so a JAX ``state_dict``
loads one to one.  Layout ``[batch, seq, d_model]``; attention takes
Paddle's ``[B, S, H, D]`` through :func:`.functional.
scaled_dot_product_attention`, which routes as the JAX package does: flash
(the CUDA kernels on the card) without a mask and without dropout, the
dense chain otherwise.  Masks pass through unchanged: a boolean mask keeps
the logits where it is True (fp32 min elsewhere), any other is added to
the fp32 logits.

Parameters are drawn from ``generator`` (its device's default generator
when None), which also draws every dropout mask; ``device=None`` means
CUDA.  As in Paddle, ``TransformerEncoder`` / ``TransformerDecoder``
deep-copy the layer they are given, so every layer starts with its
weights; the copies share the caller's generator (a deep-copied
``torch.Generator`` would replay the same masks in every layer).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from ..device import resolve_device
from . import functional as F
from .layer import Dropout, LayerNorm, Linear

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attn_mask(mask, dtype):
    """The mask as given (JAX ``transformer.py:25``): boolean masks select,
    others add."""
    return mask


def _copies(layer: torch.nn.Module, n: int):
    """``layer`` and ``n - 1`` deep copies that share its generators."""
    memo = {id(g): g for m in layer.modules() for g in vars(m).values()
            if isinstance(g, torch.Generator)}
    return [layer] + [copy.deepcopy(layer, dict(memo)) for _ in range(n - 1)]


class MultiHeadAttention(torch.nn.Module):
    """``forward(query, key=None, value=None, attn_mask=None, cache=None)``
    gives ``[B, Sq, embed_dim]``, and with a ``cache`` ``(k, v)`` (``[B, T,
    H, D]`` each, from :meth:`gen_cache` or a previous call) also the cache
    with this call's k / v appended.  ``need_weights`` is kept and never
    read, as in JAX."""

    Cache = tuple

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise AssertionError(f"embed_dim ({embed_dim}) must be a "
                                 f"multiple of num_heads ({num_heads})")
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        kw = dict(generator=generator, device=device)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr, **kw)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)
        self.generator = generator

    def _split(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split(self.q_proj(query))
        k = self._split(self.k_proj(key))
        v = self._split(self.v_proj(value))
        if cache is not None:
            pk, pv = cache
            k = torch.cat([pk, k], dim=1)
            v = torch.cat([pv, v], dim=1)
            cache = (k, v)
        mask = _convert_attn_mask(attn_mask, q.dtype)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=self.dropout,
            training=self.training, generator=self.generator)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None:
            return out, cache
        return out

    def gen_cache(self, key, value=None, type=None):
        """An empty cache ``(k, v)``: fp32 ``[B, 0, H, D]`` zeros whatever
        the layer's dtype, as in JAX, so a bf16 layer's output and caches
        come out fp32 (jnp's promotion)."""
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        return (torch.zeros(shape, device=key.device),
                torch.zeros(shape, device=key.device))


class TransformerEncoderLayer(torch.nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(generator=generator, device=device)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.dropout_act = Dropout(act_dropout, generator=generator)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            out = self.self_attn(src, src, src, src_mask)
        else:
            out, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(out)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        act = getattr(F, self.activation)
        src = self.linear2(self.dropout_act(act(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


class TransformerEncoder(torch.nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(_copies(encoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(torch.nn.Module):
    """Self attention, cross attention on ``memory``, then the FFN.
    ``forward``'s ``cache`` is taken and not read, as in JAX."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(generator=generator, device=device)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps,
                               device=device)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.dropout3 = Dropout(dropout, generator=generator)
        self.dropout_act = Dropout(act_dropout, generator=generator)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = residual + self.dropout1(self.self_attn(tgt, tgt, tgt,
                                                      tgt_mask))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = residual + self.dropout2(
            self.cross_attn(tgt, memory, memory, memory_mask))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        act = getattr(F, self.activation)
        tgt = self.linear2(self.dropout_act(act(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(torch.nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(_copies(decoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(torch.nn.Module):
    """Encoder and decoder stacks; with ``normalize_before`` each stack
    ends in a ``LayerNorm(d_model)`` (epsilon 1e-5)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            norm = LayerNorm(d_model, device=device) if normalize_before \
                else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            norm = LayerNorm(d_model, device=device) if normalize_before \
                else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, *, device=None):
        """fp32 ``[length, length]``: 0 on and below the diagonal, ``-inf``
        above."""
        return torch.full((length, length), float("-inf"),
                          device=resolve_device(device)).triu(1)
