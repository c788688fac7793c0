"""GPT configuration, presets, seeded parameters and the functional block
of the train step.

Counterpart of the functional half of ``paddle_tpu/models/gpt.py``: the
config fields, ``gpt_tiny`` ... ``gpt_13b``, a parameter tree in the
train-step layout (``wte [V, H]``, ``wpe [P, H]``, ``lnf_w`` / ``lnf_b``
``[H]`` in fp32 whatever the config's dtype, ``blocks`` stacked
``[L, ...]``) drawn from a ``torch.Generator``, and the pure block
(:func:`block_apply`, :func:`dense_causal_attention`, :func:`layer_norm`)
for dense layers without tensor or sequence parallelism and without MoE.
The imperative ``GPTForCausalLM`` is not ported (ROADMAP queue 1 item 14).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from .llama import torch_dtype

__all__ = ["GPTConfig", "gpt_tiny", "gpt_125m", "gpt_1p3b", "gpt_6p7b",
           "gpt_13b", "block_shapes", "init_params", "layer_norm",
           "dense_causal_attention", "block_apply"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
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
    from ..device import resolve_device
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
    vf = v.float()
    mean = vf.mean(-1, keepdim=True).to(v.dtype)
    var = vf.var(-1, unbiased=False, keepdim=True).to(v.dtype)
    return (v - mean) * torch.rsqrt(var + eps) * w + b


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
