"""Llama configuration, RoPE tables, seeded parameters, the functional
block of the train step and the eager model.

Counterpart of ``paddle_tpu/models/llama.py`` restricted to what the
serving engine, the one-device train step and eager training read: the
config fields, ``llama_tiny`` / ``llama_7b``, the RoPE tables
(``_rope_cos_sin``), a parameter tree in the train-step layout (``wte [V,
H]``, ``head [H, V]``, ``lnf_w [H]``, ``blocks`` stacked ``[L, ...]``)
drawn from a ``torch.Generator``, the pure block of the train step
(:func:`apply_rope`, :func:`_gqa_attention`, :func:`block_apply`) for
dense layers without tensor parallelism, and the eager ``nn.Module``
graph :class:`LlamaForCausalLM` (``llama.py:248-430``) with the JAX
attribute names, so ``state_dict()`` keys are the JAX ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..device import make_generator, resolve_device
from ..incubate.nn.functional import swiglu
from ..nn import functional as F
from ..nn.layer import Embedding, Linear, RMSNorm
from ..ops.decode_block import rotate_half
from .generation import _dense_masked_attention

__all__ = ["LlamaConfig", "llama_tiny", "llama_7b", "init_params",
           "torch_dtype", "apply_rope", "rms_norm", "block_apply",
           "LlamaAttention", "LlamaMLP", "LlamaBlock", "LlamaModel",
           "LlamaForCausalLM"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None => MHA; < num_heads => GQA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    dtype: str = "float32"
    rope_scaling: Optional[dict] = None
    # mixture-of-experts FFNs are outside this port's slices; the field is
    # kept so the engine and the train step can refuse such configs by name
    moe_num_experts: int = 0
    # the eager LlamaForCausalLM reads it (a tied head reuses
    # embed_tokens); the JAX train step keeps an untied head whatever it
    # says
    tie_word_embeddings: bool = False
    # tensor-parallel eager layers are outside this port's slices; the
    # eager model refuses the field by name
    use_mp: bool = False
    # logits-free fused linear-CE head (ops/fused_cross_entropy.py), the
    # JAX default; False takes the dense fp32-logits head
    fused_head: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


def llama_tiny(**kw) -> LlamaConfig:
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("num_kv_heads", 2)
    kw.setdefault("max_position_embeddings", 128)
    return LlamaConfig(**kw)


def llama_7b(**kw) -> LlamaConfig:
    kw.setdefault("hidden_size", 4096)
    kw.setdefault("intermediate_size", 11008)
    kw.setdefault("num_layers", 32)
    kw.setdefault("num_heads", 32)
    return LlamaConfig(**kw)


def torch_dtype(name) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` (the config's string) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unsupported dtype {name!r}; use one of "
                         f"{sorted(table)}")
    return table[name]


def _rope_cos_sin(seq_len: int, head_dim: int, theta: float, dtype,
                  scaling: Optional[dict] = None, device=None,
                  dynamic: bool = False):
    """RoPE tables ``[seq_len, head_dim]`` with HuggingFace-compatible
    ``linear`` and ``llama3`` scaling, computed in fp32 and cast to
    ``dtype``.  ``dynamic`` NTK scaling depends on the current sequence
    length: the train step, which builds its table at the step's own
    length, passes ``dynamic=True`` and gets the JAX package's branch
    (theta rescaled once ``seq_len`` exceeds the original length); a
    serving table baked at ``max_position_embeddings`` cannot represent it,
    so there it raises."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv = 1.0 / (theta ** exps)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    if scaling:
        kind = scaling.get("rope_type", scaling.get("type"))
        if kind is None:
            raise ValueError("rope_scaling needs a 'rope_type' (or legacy "
                             "'type') key")
        factor = float(scaling.get("factor", 1.0))
        if kind == "linear":
            t = t / factor
        elif kind == "dynamic" and dynamic:
            orig = int(scaling.get("original_max_position_embeddings") or 0)
            if not orig:
                raise ValueError("dynamic rope_scaling needs "
                                 "'original_max_position_embeddings'")
            if seq_len > orig:
                base = theta * (factor * seq_len / orig - (factor - 1)) ** (
                    head_dim / (head_dim - 2))
                inv = 1.0 / (base ** exps)
        elif kind == "dynamic":
            raise NotImplementedError(
                "dynamic-NTK rope depends on the current sequence length; "
                "the engine bakes one table at max_position_embeddings — "
                "use 'linear' or 'llama3' scaling for serving")
        elif kind == "llama3":
            orig = int(scaling.get("original_max_position_embeddings") or 0)
            if not orig:
                raise ValueError("llama3 rope_scaling needs "
                                 "'original_max_position_embeddings'")
            lo = float(scaling["low_freq_factor"])
            hi = float(scaling["high_freq_factor"])
            low_wl, high_wl = orig / lo, orig / hi
            wl = 2.0 * math.pi / inv
            smooth = (orig / wl - lo) / (hi - lo)
            interp = (1 - smooth) * inv / factor + smooth * inv
            inv = torch.where(wl > low_wl, inv / factor,
                              torch.where(wl < high_wl, inv, interp))
        else:
            raise ValueError(f"unknown rope_type {kind!r}")
    freqs = torch.outer(t, inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def block_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    """Per-layer weight shapes, JAX layout ``[in, out]``."""
    h, f, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    return {"ln1_w": (h,), "ln2_w": (h,),
            "q_w": (h, cfg.num_heads * d), "k_w": (h, cfg.kv_heads * d),
            "v_w": (h, cfg.kv_heads * d), "o_w": (cfg.num_heads * d, h),
            "gate_w": (h, f), "up_w": (h, f), "down_w": (f, h)}


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> Dict[str, object]:
    """Seeded random parameters in the train-step tree layout, blocks
    stacked ``[L, ...]``: normals of std ``initializer_range`` for every
    matrix, ones for the norm gains, in ``cfg.dtype``.  The numbers differ
    from the JAX package's (another generator); tests that compare the two
    packages build one tree with numpy and hand it to both."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    std = cfg.initializer_range
    L, h, v = cfg.num_layers, cfg.hidden_size, cfg.vocab_size

    def normal(*shape):
        out = torch.empty(shape, dtype=dt, device=dev)
        return out.normal_(0.0, std, generator=generator)

    blocks = {}
    for name, shape in block_shapes(cfg).items():
        blocks[name] = (torch.ones((L,) + shape, dtype=dt, device=dev)
                        if name.startswith("ln") else normal(L, *shape))
    return {"wte": normal(v, h), "head": normal(h, v),
            "lnf_w": torch.ones(h, dtype=dt, device=dev), "blocks": blocks}


# ------------------------------------------------------------ train step
def apply_rope(q, k, cos, sin):
    """q, k ``[b, s, h, d]``; cos/sin ``[s, d]`` (rotate-half RoPE)."""
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def _gqa_attention(q, k, v, causal: bool = True):
    """Dense attention, the train step's ``use_flash=False`` path: q
    ``[b, s, hq, d]``, k/v ``[b, s, hkv, d]``; logits in the input dtype,
    softmax in fp32, probabilities cast back before the value product."""
    s = q.shape[1]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    return _dense_masked_attention(q, k, v, mask.tril() if causal else mask,
                                   1.0 / math.sqrt(q.shape[-1]))


def rms_norm(x, w, eps: float):
    """The train step's RMSNorm: scale computed in fp32, the normalised
    value rounded to x's dtype, then times the gain."""
    return F.rms_norm(x, w, None, eps)


def block_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: LlamaConfig, cos, sin, attn_fn=None) -> torch.Tensor:
    """One dense Llama block of the train step (the JAX ``block_apply``
    without tensor or sequence parallelism and without MoE).  ``attn_fn(q,
    k, v)`` takes ``[b, s, h, d]`` with grouped kv heads; None takes the
    dense :func:`_gqa_attention`."""
    b, s = x.shape[0], x.shape[1]
    eps = cfg.rms_norm_eps
    res = x
    y = rms_norm(x, params["ln1_w"], eps)
    q = (y @ params["q_w"]).reshape(b, s, -1, cfg.head_dim)
    k = (y @ params["k_w"]).reshape(b, s, -1, cfg.head_dim)
    v = (y @ params["v_w"]).reshape(b, s, -1, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)
    attn = attn_fn(q, k, v) if attn_fn is not None else \
        _gqa_attention(q, k, v, causal=True)
    x = res + attn.reshape(b, s, -1) @ params["o_w"]
    y = rms_norm(x, params["ln2_w"], eps)
    h = torch.nn.functional.silu(y @ params["gate_w"]) * (y @ params["up_w"])
    return x + h @ params["down_w"]


# ------------------------------------------------------------ eager model
def _refuse(what: str, item: int, name: str):
    raise NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP queue 1 "
        f"item {item}: {name})")


def _refuse_unported(cfg) -> None:
    """Refuse by name what the eager Llama does not port."""
    if cfg.use_mp:
        _refuse("use_mp (tensor-parallel eager layers)", 17,
                "training runtime and distributed parallelism")
    if cfg.moe_num_experts:
        _refuse("mixture-of-experts FFNs", 15, "MoE")


class LlamaAttention(torch.nn.Module):
    """q/k/v/o projections without bias; RoPE and the dense grouped-query
    causal attention of the JAX eager op ``_rope_gqa_attention`` (plain
    torch ops: the JAX package runs no kernel there either)."""

    def __init__(self, cfg: LlamaConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.hidden_size, cfg.head_dim
        kw = dict(bias_attr=False, generator=generator, device=device)
        self.q_proj = Linear(h, cfg.num_heads * d, **kw)
        self.k_proj = Linear(h, cfg.kv_heads * d, **kw)
        self.v_proj = Linear(h, cfg.kv_heads * d, **kw)
        self.o_proj = Linear(cfg.num_heads * d, h, **kw)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).reshape(b, s, cfg.kv_heads, cfg.head_dim)
        v = self.v_proj(x).reshape(b, s, cfg.kv_heads, cfg.head_dim)
        q, k = apply_rope(q, k, cos, sin)
        out = _gqa_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, cfg.num_heads * cfg.head_dim))


class LlamaMLP(torch.nn.Module):
    """``down(swiglu(gate(x), up(x)))``: the ``swiglu_fwd`` kernel on
    CUDA."""

    def __init__(self, cfg: LlamaConfig, *, generator=None, device=None):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        kw = dict(bias_attr=False, generator=generator, device=device)
        self.gate_proj = Linear(h, f, **kw)
        self.up_proj = Linear(h, f, **kw)
        self.down_proj = Linear(f, h, **kw)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaBlock(torch.nn.Module):
    """Pre-norm block; both RMSNorms take the ``rms_norm_fwd`` kernel on
    CUDA."""

    def __init__(self, cfg: LlamaConfig, *, generator=None, device=None):
        super().__init__()
        _refuse_unported(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       device=device)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, device=device)
        self.self_attn = LlamaAttention(cfg, generator=generator,
                                        device=device)
        self.mlp = LlamaMLP(cfg, generator=generator, device=device)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(torch.nn.Module):
    def __init__(self, cfg: LlamaConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size,
                                      std=cfg.initializer_range,
                                      generator=generator, device=device)
        self.layers = torch.nn.ModuleList(
            [LlamaBlock(cfg, generator=generator, device=device)
             for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=device)

    def forward(self, input_ids):
        cfg = self.cfg
        dt = self.embed_tokens.weight.dtype
        if dt.is_floating_point and dt.itemsize < torch_dtype(
                cfg.dtype).itemsize:
            # the JAX package would run RoPE and attention in the wider
            # dtype and mix dtypes in the products, which torch refuses
            raise ValueError(f"the parameters are {dt} but cfg.dtype is "
                             f"{cfg.dtype!r}: build the config with "
                             f"dtype={str(dt).split('.')[-1]!r}")
        cos, sin = _rope_cos_sin(input_ids.shape[1], cfg.head_dim,
                                 cfg.rope_theta, torch_dtype(cfg.dtype),
                                 cfg.rope_scaling, device=input_ids.device,
                                 dynamic=True)
        x = self.embed_tokens(input_ids)
        for blk in self.layers:
            x = blk(x, cos, sin)
        return self.norm(x)


class LlamaForCausalLM(torch.nn.Module):
    """The eager Llama: ``net(ids)`` gives logits ``[b, s, V]``,
    ``net(ids, labels)`` the mean cross-entropy over labels other than
    -100, through the fused linear-CE head when ``cfg.fused_head`` (the
    linear-CE kernels on CUDA), else the dense head.

    Parameters are fp32, drawn from ``generator`` (seed 0 on ``device``
    when None); ``device=None`` means CUDA.  Cast with
    ``.to(torch.bfloat16)``.  ``use_mp`` and ``moe_num_experts`` raise
    ``NotImplementedError`` naming their ROADMAP items."""

    def __init__(self, cfg: LlamaConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _refuse_unported(cfg)
        dev = resolve_device(device)
        gen = generator if generator is not None else make_generator(0, dev)
        self.cfg = cfg
        self.llama = LlamaModel(cfg, generator=gen, device=dev)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias_attr=False, generator=gen, device=dev)

    def forward(self, input_ids, labels=None):
        cfg = self.cfg
        h = self.llama(input_ids)
        tied = cfg.tie_word_embeddings
        w = self.llama.embed_tokens.weight if tied else self.lm_head.weight
        if labels is not None and cfg.fused_head:
            return F.fused_linear_cross_entropy(
                h, w, labels, w_layout="vh" if tied else "hv")
        logits = h @ w.t() if tied else self.lm_head(h)
        if labels is not None:
            return F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                   labels.reshape(-1))
        return logits
