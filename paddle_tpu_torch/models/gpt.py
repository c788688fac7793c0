"""GPT configuration, presets, seeded parameters, the functional block of
the train step and the eager model.

Counterpart of ``paddle_tpu/models/gpt.py``: the config fields,
``gpt_tiny`` ... ``gpt_13b``, a parameter tree in the train-step layout
(``wte [V, H]``, ``wpe [P, H]``, ``lnf_w`` / ``lnf_b`` ``[H]`` in fp32
whatever the config's dtype, ``blocks`` stacked ``[L, ...]``) drawn from
a ``torch.Generator``, the pure block (:func:`block_apply`,
:func:`dense_causal_attention`, :func:`layer_norm`) for dense layers
without tensor or sequence parallelism and without MoE, and the eager
``nn.Module`` graph :class:`GPTForCausalLM` (``gpt.py:132-280``) with the
JAX attribute names, on the fused block epilogues of ``gpt.py:184-202``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..device import make_generator, resolve_device
from ..nn import functional as F
from ..nn.layer import Dropout, Embedding, LayerNorm, Linear
from .llama import torch_dtype

__all__ = ["GPTConfig", "gpt_tiny", "gpt_125m", "gpt_1p3b", "gpt_6p7b",
           "gpt_13b", "block_shapes", "init_params", "layer_norm",
           "dense_causal_attention", "block_apply", "GPTBlock", "GPTModel",
           "GPTForCausalLM"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    # dropout, use_mp and tie_word_embeddings are read by the eager
    # GPTForCausalLM (use_mp is refused by name); the one-device train
    # step trains without dropout on a tied head whatever they say, as the
    # JAX step does
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    use_mp: bool = False
    tie_word_embeddings: bool = True
    dtype: str = "float32"
    # mixture-of-experts FFNs are outside this port's slices; the field is
    # kept so the train step can refuse such configs by name
    moe_num_experts: int = 0
    # logits-free fused linear-CE head (ops/fused_cross_entropy.py)
    fused_head: bool = True

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def gpt_tiny(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=128, hidden_size=64, num_layers=4,
                     num_heads=4, max_position_embeddings=64, **kw)


def gpt_125m(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt_1p3b(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                     max_position_embeddings=2048, **kw)


def gpt_6p7b(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=4096, num_layers=32, num_heads=32,
                     max_position_embeddings=2048, **kw)


def gpt_13b(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=5120, num_layers=40, num_heads=40,
                     max_position_embeddings=2048, **kw)


def block_shapes(cfg: GPTConfig) -> Dict[str, tuple]:
    """Per-layer parameter shapes, JAX layout ``[in, out]``."""
    h, f = cfg.hidden_size, cfg.ffn_size
    return {"ln1_w": (h,), "ln1_b": (h,), "ln2_w": (h,), "ln2_b": (h,),
            "qkv_w": (h, 3 * h), "qkv_b": (3 * h,), "proj_w": (h, h),
            "proj_b": (h,), "fc1_w": (h, f), "fc1_b": (f,), "fc2_w": (f, h),
            "fc2_b": (h,)}


def init_params(cfg: GPTConfig, generator: torch.Generator,
                device=None) -> Dict[str, object]:
    """Seeded random parameters in the train-step tree layout: normals of
    std ``initializer_range`` for ``wte``, ``wpe`` and every matrix, ones
    for the norm gains, zeros for the biases, all in ``cfg.dtype`` except
    ``lnf_w`` / ``lnf_b``, which are fp32 as in the JAX package.  The
    numbers differ from the JAX package's (another generator); tests that
    compare the two hand one numpy tree to both."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    std = cfg.initializer_range
    L, h = cfg.num_layers, cfg.hidden_size

    def normal(*shape):
        out = torch.empty(shape, dtype=dt, device=dev)
        return out.normal_(0.0, std, generator=generator)

    blocks = {}
    for name, shape in block_shapes(cfg).items():
        if name.endswith("_w") and name.startswith("ln"):
            blocks[name] = torch.ones((L,) + shape, dtype=dt, device=dev)
        elif name.endswith("_b"):
            blocks[name] = torch.zeros((L,) + shape, dtype=dt, device=dev)
        else:
            blocks[name] = normal(L, *shape)
    return {"wte": normal(cfg.vocab_size, h),
            "wpe": normal(cfg.max_position_embeddings, h),
            "lnf_w": torch.ones(h, dtype=torch.float32, device=dev),
            "lnf_b": torch.zeros(h, dtype=torch.float32, device=dev),
            "blocks": blocks}


def layer_norm(v, w, b, eps: float):
    """LayerNorm with the JAX package's rounding: mean and variance taken
    in fp32 and rounded to v's dtype, then ``(v - mean) * rsqrt(var + eps)
    * w + b`` with dtype promotion (bf16 v with the fp32 final gains gives
    fp32)."""
    return F.layer_norm(v, v.shape[-1], w, b, eps)


def dense_causal_attention(q, k, v):
    """Plain causal attention, ``[B, S, H, D]`` in and out: logits in the
    input dtype, masked and soft-maxed in fp32, probabilities cast back
    before the value product (the ``use_flash=False`` path)."""
    s = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(
        q.shape[-1]))
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask, logits.float(),
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=q.device))
    probs = torch.softmax(logits, -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def block_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: GPTConfig, attn_fn=None) -> torch.Tensor:
    """One dense GPT block of the train step (the JAX ``block_apply``
    without tensor or sequence parallelism and without MoE): pre-LN
    attention with a fused qkv projection split per head (q, k and v are
    strided views of ``[b, s, heads, 3 * D]``), then a tanh-GELU MLP.
    ``attn_fn(q, k, v)`` takes ``[b, s, heads, D]``; None takes
    :func:`dense_causal_attention`."""
    b, s = x.shape[0], x.shape[1]
    eps = cfg.layer_norm_eps
    res = x
    qkv = layer_norm(x, params["ln1_w"], params["ln1_b"], eps) \
        @ params["qkv_w"] + params["qkv_b"]
    q, k, v = qkv.reshape(b, s, -1, 3 * cfg.head_dim).split(cfg.head_dim,
                                                            dim=-1)
    attn = (attn_fn or dense_causal_attention)(q, k, v).reshape(b, s, -1)
    x = res + attn @ params["proj_w"] + params["proj_b"]
    y = layer_norm(x, params["ln2_w"], params["ln2_b"], eps) \
        @ params["fc1_w"]
    y = torch.nn.functional.gelu(y + params["fc1_b"], approximate="tanh")
    return x + y @ params["fc2_w"] + params["fc2_b"]


# ------------------------------------------------------------ eager model
def _refuse_unported(cfg) -> None:
    """Refuse by name what the eager GPT does not port."""
    if cfg.use_mp:
        raise NotImplementedError(
            "use_mp (tensor-parallel eager layers) is not ported to "
            "paddle_tpu_torch yet (ROADMAP queue 1 item 17: training "
            "runtime and distributed parallelism)")
    if cfg.moe_num_experts:
        raise NotImplementedError(
            "mixture-of-experts FFNs are not ported to paddle_tpu_torch yet "
            "(ROADMAP queue 1 item 15: MoE)")


class GPTBlock(torch.nn.Module):
    """Pre-LN block on the JAX package's fused epilogues (its TPU
    structure): ``ln1`` through the fused LayerNorm (``layer_norm_fwd`` on
    CUDA), the fused qkv split per head (``[b, s, H, 3 D]``: q, k, v
    strided views), attention through ``F.scaled_dot_product_attention``
    (the flash kernels without dropout), the projection's bias, dropout,
    residual add and ``ln2`` through the fused bias-residual LayerNorm
    (``bias_residual_ln_fwd``), then a tanh-GELU MLP."""

    def __init__(self, cfg: GPTConfig, *, generator=None, device=None):
        super().__init__()
        _refuse_unported(cfg)
        self.cfg = cfg
        h = cfg.hidden_size
        kw = dict(generator=generator, device=device)
        self.ln1 = LayerNorm(h, cfg.layer_norm_eps, device=device)
        self.ln2 = LayerNorm(h, cfg.layer_norm_eps, device=device)
        self.qkv = Linear(h, 3 * h, **kw)
        self.proj = Linear(h, h, **kw)
        self.fc1 = Linear(h, cfg.ffn_size, **kw)
        self.fc2 = Linear(cfg.ffn_size, h, **kw)
        self.drop = Dropout(cfg.dropout, generator=generator)

    def forward(self, x):
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        gen = self.drop.generator
        residual = x
        y = F.fused_layer_norm(x, self.ln1.weight, self.ln1.bias,
                               cfg.layer_norm_eps)
        qkv = self.qkv(y).reshape(b, s, cfg.num_heads, 3 * cfg.head_dim)
        q, k, v = qkv.split(cfg.head_dim, dim=-1)
        attn = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=cfg.dropout,
            training=self.training, generator=gen)
        proj = attn.reshape(b, s, cfg.hidden_size) @ self.proj.weight
        y, x = F.fused_bias_dropout_residual_layer_norm(
            proj, residual, self.proj.bias, self.ln2.weight, self.ln2.bias,
            dropout_rate=cfg.dropout, epsilon=cfg.layer_norm_eps,
            training=self.training, return_add_out=True, generator=gen)
        y = self.fc2(F.gelu(self.fc1(y), approximate=True))
        return x + self.drop(y)


class GPTModel(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(std=cfg.initializer_range, generator=generator,
                  device=device)
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             **kw)
        self.drop = Dropout(cfg.dropout, generator=generator)
        self.blocks = torch.nn.ModuleList(
            [GPTBlock(cfg, generator=generator, device=device)
             for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                              device=device)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(torch.nn.Module):
    """The eager GPT: ``net(ids)`` gives logits ``[b, s, V]``, ``net(ids,
    labels)`` the mean cross-entropy over labels other than -100, through
    the fused linear-CE head when ``cfg.fused_head`` (on the tied ``wte``,
    ``"vh"``, by default), else the dense head.  ``ln_f`` is the plain
    LayerNorm chain, as in the JAX package.

    Parameters are fp32, drawn from ``generator`` (seed 0 on ``device``
    when None), which also draws the dropout masks; ``device=None`` means
    CUDA.  ``use_mp`` and ``moe_num_experts`` raise
    ``NotImplementedError`` naming their ROADMAP items."""

    def __init__(self, cfg: GPTConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _refuse_unported(cfg)
        dev = resolve_device(device)
        gen = generator if generator is not None else make_generator(0, dev)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, generator=gen, device=dev)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias_attr=False, generator=gen, device=dev)

    def forward(self, input_ids, labels=None):
        cfg = self.cfg
        h = self.gpt(input_ids)
        tied = cfg.tie_word_embeddings
        w = self.gpt.wte.weight if tied else self.lm_head.weight
        if labels is not None and cfg.fused_head:
            return F.fused_linear_cross_entropy(
                h, w, labels, w_layout="vh" if tied else "hv")
        logits = h @ w.t() if tied else self.lm_head(h)
        if labels is not None:
            return F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                   labels.reshape(-1))
        return logits
