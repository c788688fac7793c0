"""Autoregressive generation: KV-cache prefill, per-token decode steps and
sampling, for the Llama and GPT parameter trees.

Counterpart of ``paddle_tpu/models/generation.py``.  The public functions
keep the JAX package's names, arguments and layouts: parameter trees in
the train-step layout with blocks stacked ``[L, ...]`` (a JAX tree goes
through ``bridge.params_from_numpy``), ids ``[B, T]``, a cache
``{"k", "v"}`` of ``[L, B, max_len, Hkv, D]``, fp32 logits.  What differs
is PyTorch idiom:

* Entry points run on the card unless ``device="cpu"`` is passed; without
  CUDA they raise (:mod:`paddle_tpu_torch.device`).  Parameters must
  already live on that device.
* The KV cache is updated IN PLACE: ``prefill`` allocates it, ``step``
  and ``chunk_step`` write the new rows into the tensors they are given
  and return the same dict (the JAX package rebuilds it functionally).
* Sampling with ``seed=`` (and no ``generator=``) draws the JAX
  package's bits: ``jax.random.key(seed)`` split into a first key and a
  loop key, the loop key split again each step, and the Gumbel-max draw
  of ``jax.random.categorical`` over ``[B, V]`` (``ops/threefry.py``),
  so over equal logits the sampled ids are the JAX package's.  A
  caller's :class:`torch.Generator` draws by ``torch.multinomial``
  instead, a stream of its own.
* Nothing is compiled: the rollout is a Python loop over steps and
  layers, so ``_RUN_CACHE`` has no counterpart.

On a CUDA device each decode step runs the ``decode_attention`` kernel once
per layer and, for a quantized Llama, every block matmul through the
weight-only kernels (``nn.quant.weight_only_linear``); the bf16 matmuls,
norms, RoPE and the prefill's dense attention are PyTorch ops, as they are
XLA ops in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import threefry
from ..ops.decode_attention import decode_attention
from ..ops.decode_block import rotate_half

__all__ = ["sample_logits", "filter_logits", "gpt_generate",
           "llama_generate", "llama_speculative_generate",
           "gpt_speculative_generate", "build_gpt_decoder",
           "build_llama_decoder", "quantize_llama_params",
           "_collapse_blocks", "_dense_masked_attention"]

QUANT_ALGOS = ("weight_only_int8", "weight_only_int4")


# ----------------------------------------------------------------- helpers
def _collapse_blocks(blocks: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """[S, per, ...] (pipeline-stacked) -> [L, ...]."""
    return {k: v.reshape((-1,) + tuple(v.shape[2:]))
            for k, v in blocks.items()}


def _dense_masked_attention(q, k, v, mask, scale):
    """q [B,Q,H,D] vs k/v [B,T,Hkv,D] (GQA-repeat inside) under a
    broadcastable boolean mask [.,.,Q,T].  Rounding as in the JAX
    package: q·k in the input dtype, softmax in fp32, probabilities cast
    back to the input dtype, p·v in the input dtype."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    # a Python scalar, not a tensor made on the host: the draft program
    # runs this under CUDA graph capture, where a host copy may not run
    logits = torch.where(mask, logits.float(), -1e30)
    p = torch.softmax(logits, -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _rope_rows(q, k, cos_bt, sin_bt):
    """Per-row RoPE: q, k [B, S, h, d]; cos/sin [B, S, d] gathered at each
    row's own positions (the batched speculative case)."""
    c, s = cos_bt[:, :, None, :], sin_bt[:, :, None, :]
    return q * c + rotate_half(q) * s, k * c + rotate_half(k) * s


def _causal(n: int, device) -> torch.Tensor:
    return torch.ones((n, n), dtype=torch.bool, device=device).tril()


class _Unstacked:
    """Per-layer views of a parameter tree's stacked blocks, and an fp32
    copy of its head, built once per tree (the decode loop indexes them
    every step).  Keyed by the identity of the ``blocks`` dict and of the
    head tensor: a tree edited in place after a call is not seen."""

    def __init__(self, head_key: str, transpose: bool):
        self.head_key, self.transpose = head_key, transpose
        self.key = None

    def __call__(self, params):
        key = (params["blocks"], params[self.head_key])
        if self.key is None or any(a is not b for a, b in zip(key,
                                                              self.key)):
            blocks = params["blocks"]
            n = next(iter(blocks.values())).shape[0]
            self.layers = [{k: v[i] for k, v in blocks.items()}
                           for i in range(n)]
            head = params[self.head_key].float()
            self.head = head.t() if self.transpose else head
            self.key = key
        return self.layers, self.head


def _empty_cache(L, B, max_len, Hkv, D, dtype, device):
    return {"k": torch.zeros((L, B, max_len, Hkv, D), dtype=dtype,
                             device=device),
            "v": torch.zeros((L, B, max_len, Hkv, D), dtype=dtype,
                             device=device)}


def _positions(pos, B, device):
    """``(lengths [B] int32, pos_vec [B] long or None)`` for a scalar or
    per-row ``pos``."""
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        pv = pos.to(device=device, dtype=torch.long)
        return (pv + 1).to(torch.int32), pv
    p = int(pos)
    return torch.full((B,), p + 1, dtype=torch.int32, device=device), None


def _check_device(params, dev, key):
    got = params[key].device
    if got.type != dev.type or (dev.index is not None
                                and got.index not in (None, dev.index)):
        raise ValueError(f"params live on {got}, the decoder runs on {dev}; "
                         f"move them there first")


# ---------------------------------------------------------------- sampling
def filter_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """The logits :func:`sample_logits` draws from: fp32 ``logits /
    temperature`` with ``-inf`` outside the top-k and outside the smallest
    prefix (by descending logit) whose probability reaches ``top_p``, the
    JAX package's rule (ties at the cut stay in)."""
    out = logits.float() / temperature
    if top_k is not None and top_k > 0:
        kth = torch.sort(out, dim=-1).values[:, -top_k][:, None]
        out = torch.where(out < kth, -math.inf, out)
    if top_p is not None and 0.0 < top_p < 1.0:
        desc = torch.sort(out, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(desc, dim=-1), dim=-1)
        cut_idx = (cum < top_p).sum(-1, keepdim=True).clamp(
            max=out.shape[-1] - 1)
        cutoff = torch.gather(desc, -1, cut_idx)
        out = torch.where(out < cutoff, -math.inf, out)
    return out


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None, key=None) -> torch.Tensor:
    """Token ids ``[B]`` (int64) from ``[B, V]`` logits: argmax when
    ``temperature <= 0``, else one categorical draw per row from
    :func:`filter_logits`' logits: with ``key`` (a ``threefry`` word
    pair) ``jax.random.categorical``'s draw, ``argmax(logits +
    gumbel)`` over the key's ``[B, V]`` bits; else ``torch.multinomial``
    with ``generator``."""
    if temperature is None or temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    x = filter_logits(logits, temperature, top_k, top_p)
    if key is not None:
        bits = threefry.random_bits(key[0], key[1], tuple(x.shape),
                                    x.device)
        return torch.argmax(x + threefry.gumbel(bits), dim=-1)
    probs = torch.softmax(x, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


# ------------------------------------------------------------- GPT decoder
def build_gpt_decoder(cfg, max_len: int, with_chunk: bool = False,
                      device=None):
    """``(prefill, step[, chunk_step])`` for the GPT tree (tied ``wte``
    head, learned positions, fused qkv with bias, tanh GELU).

    ``prefill(params, ids [B, T0])`` -> ``(cache, logits [B, V])``;
    ``step(params, cache, token [B], pos)`` -> ``(cache, logits)`` with
    ``pos`` an int or a ``[B]`` tensor of per-row positions;
    ``chunk_step(params, cache, toks [B, K1], pos)`` -> ``(cache,
    logits [B, K1, V])``.  The cache is updated in place."""
    from .gpt import layer_norm
    dev = resolve_device(device)
    if getattr(cfg, "moe_num_experts", 0):
        raise NotImplementedError(
            "MoE FFNs in generation are not ported yet — ROADMAP queue 1 "
            "item 15")
    H, D, L = cfg.num_heads, cfg.head_dim, cfg.num_layers
    eps = cfg.layer_norm_eps
    scale = 1.0 / math.sqrt(D)
    unstack = _Unstacked("wte", transpose=True)

    def ln(x, w, b):
        return layer_norm(x, w, b, eps)

    def block(lp, x, attend):
        """One layer: ``attend(q, k, v)`` takes ``[..., H, D]`` rows."""
        y = ln(x, lp["ln1_w"], lp["ln1_b"])
        qkv = (y @ lp["qkv_w"] + lp["qkv_b"]).reshape(*x.shape[:-1], H,
                                                      3 * D)
        q, k, v = qkv.split(D, dim=-1)
        attn = attend(q, k, v).reshape(*x.shape[:-1], -1)
        x = x + attn @ lp["proj_w"] + lp["proj_b"]
        h = F.gelu(ln(x, lp["ln2_w"], lp["ln2_b"]) @ lp["fc1_w"]
                   + lp["fc1_b"], approximate="tanh")
        return x + (h @ lp["fc2_w"] + lp["fc2_b"])

    def final_logits(params, head, x):
        return ln(x, params["lnf_w"], params["lnf_b"]).float() @ head

    def prefill(params, ids):
        _check_device(params, dev, "wte")
        layers, head = unstack(params)
        B, T0 = ids.shape
        x = params["wte"][ids] + params["wpe"][:T0][None]
        cache = _empty_cache(L, B, max_len, H, D, x.dtype, dev)
        mask = _causal(T0, dev)
        for i, lp in enumerate(layers):
            def attend(q, k, v, i=i):
                cache["k"][i, :, :T0] = k
                cache["v"][i, :, :T0] = v
                return _dense_masked_attention(q, k, v, mask, scale)
            x = block(lp, x, attend)
        return cache, final_logits(params, head, x[:, -1])

    def step(params, cache, token, pos):
        layers, head = unstack(params)
        B = token.shape[0]
        lengths, pv = _positions(pos, B, dev)
        x = params["wte"][token] + (params["wpe"][pv] if pv is not None
                                    else params["wpe"][int(pos)][None])
        rows = torch.arange(B, device=dev)
        for i, lp in enumerate(layers):
            def attend(q, k, v, i=i):
                kc, vc = cache["k"][i], cache["v"][i]
                if pv is not None:
                    kc[rows, pv], vc[rows, pv] = k, v
                else:
                    kc[:, int(pos)], vc[:, int(pos)] = k, v
                return decode_attention(q, kc, vc, lengths, scale)
            x = block(lp, x, attend)
        return cache, final_logits(params, head, x)

    def chunk_step(params, cache, toks, pos):
        layers, head = unstack(params)
        B, K1 = toks.shape
        pos_ids, mask, write = _chunk_geometry(pos, B, K1, max_len, dev)
        x = params["wte"][toks] + params["wpe"][pos_ids]
        for i, lp in enumerate(layers):
            def attend(q, k, v, i=i):
                kc, vc = cache["k"][i], cache["v"][i]
                write(kc, k)
                write(vc, v)
                return _dense_masked_attention(q, kc, vc, mask, scale)
            x = block(lp, x, attend)
        return cache, final_logits(params, head, x)

    if with_chunk:
        return prefill, step, chunk_step
    return prefill, step


def _chunk_geometry(pos, B, K1, max_len, dev):
    """``(pos_ids [B, K1] or [K1], mask, write(cache_l, rows))`` of a
    speculative verify chunk at scalar or per-row ``pos``."""
    jpos = torch.arange(max_len, device=dev)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        pos_ids = pos.to(device=dev, dtype=torch.long)[:, None] \
            + torch.arange(K1, device=dev)[None, :]           # [B, K1]
        mask = jpos[None, None, None, :] <= pos_ids[:, None, :, None]
        rows = torch.arange(B, device=dev)[:, None]

        def write(c, new):
            c[rows, pos_ids] = new
        return pos_ids, mask, write
    p = int(pos)
    pos_ids = p + torch.arange(K1, device=dev)
    mask = jpos[None, None, None, :] <= pos_ids[None, None, :, None]

    def write(c, new):
        c[:, p:p + K1] = new
    return pos_ids, mask, write


# ----------------------------------------------------------- Llama decoder
def quantize_llama_params(params, algo: str = "weight_only_int8"):
    """Quantize every block matmul weight of a Llama tree for weight-only
    decode (per output channel): each block leaf ``<name>`` ``[L, K, N]``
    becomes ``<name>__q`` (int8 ``[L, K, N]`` or packed int4
    ``[L, ceil(K/2), N]``) and ``<name>__s`` (fp32 ``[L, N]``); the norm
    gains and the top-level leaves stay."""
    from ..nn.quant import weight_quantize
    if algo not in QUANT_ALGOS:
        raise ValueError(f"algo must be one of {QUANT_ALGOS}, got {algo!r}")
    out = {k: v for k, v in params.items() if k != "blocks"}
    qblocks = {}
    for name, v in params["blocks"].items():
        if name.endswith("_w") and v.ndim >= 3 and not name.startswith("ln"):
            qs = [weight_quantize(v[i], algo) for i in range(v.shape[0])]
            qblocks[name + "__q"] = torch.stack([q for q, _ in qs])
            qblocks[name + "__s"] = torch.stack([s for _, s in qs])
        else:
            qblocks[name] = v
    out["blocks"] = qblocks
    return out


def build_llama_decoder(cfg, max_len: int, quant: Optional[str] = None,
                        with_chunk: bool = False, device=None):
    """The contract of :func:`build_gpt_decoder` for the Llama family
    (RMSNorm, RoPE, GQA cache ``[L, B, T, Hkv, D]``, SwiGLU, untied fp32
    head).  ``quant`` "weight_only_int8" / "weight_only_int4" takes a tree
    from :func:`quantize_llama_params`; every block matmul then runs
    through ``nn.quant.weight_only_linear``."""
    from .llama import _rope_cos_sin, apply_rope, torch_dtype
    from ..nn.quant import weight_only_linear
    dev = resolve_device(device)
    if getattr(cfg, "moe_num_experts", 0):
        raise NotImplementedError(
            "MoE FFNs in generation are not ported yet — ROADMAP queue 1 "
            "item 15")
    if quant is not None and quant not in QUANT_ALGOS:
        raise ValueError(f"quant must be None or one of {QUANT_ALGOS}, got "
                         f"{quant!r}")
    rs = getattr(cfg, "rope_scaling", None)
    if rs and rs.get("rope_type", rs.get("type")) == "dynamic":
        raise NotImplementedError(
            "dynamic-NTK rope depends on the current sequence length; the "
            "decoder bakes one table at max_len, which would mis-scale "
            "shorter prefixes — use 'linear' or 'llama3'")
    H, Hkv, D, L = cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.num_layers
    eps = cfg.rms_norm_eps
    scale = 1.0 / math.sqrt(D)
    cos_full, sin_full = _rope_cos_sin(max_len, D, cfg.rope_theta,
                                       torch_dtype(cfg.dtype), rs,
                                       device=dev)
    unstack = _Unstacked("head", transpose=False)

    if quant is None:
        def mm(lp, name, y):
            return y @ lp[name]
    else:
        wdt = "int4" if quant == "weight_only_int4" else "int8"

        def mm(lp, name, y):
            return weight_only_linear(y, lp[name + "__q"],
                                      weight_scale=lp[name + "__s"],
                                      weight_dtype=wdt)

    def rms(x, w):
        """The decoder's RMSNorm: the inverse rounded to x's dtype before
        the multiply (not the train step's ``rms_norm``)."""
        ms = x.float().square().mean(-1, keepdim=True)
        return (x * torch.rsqrt(ms + eps).to(x.dtype)) * w

    def block(lp, x, rope, attend):
        lead = x.shape[:-1]
        y = rms(x, lp["ln1_w"])
        q = mm(lp, "q_w", y).reshape(*lead, H, D)
        k = mm(lp, "k_w", y).reshape(*lead, Hkv, D)
        v = mm(lp, "v_w", y).reshape(*lead, Hkv, D)
        q, k = rope(q, k)
        x = x + mm(lp, "o_w", attend(q, k, v).reshape(*lead, -1))
        y = rms(x, lp["ln2_w"])
        return x + mm(lp, "down_w", F.silu(mm(lp, "gate_w", y))
                      * mm(lp, "up_w", y))

    def final_logits(params, head, x):
        return rms(x, params["lnf_w"]).float() @ head

    def prefill(params, ids):
        _check_device(params, dev, "wte")
        layers, head = unstack(params)
        B, T0 = ids.shape
        x = params["wte"][ids]
        cache = _empty_cache(L, B, max_len, Hkv, D, x.dtype, dev)
        cos, sin = cos_full[:T0], sin_full[:T0]
        mask = _causal(T0, dev)
        for i, lp in enumerate(layers):
            def attend(q, k, v, i=i):
                cache["k"][i, :, :T0] = k
                cache["v"][i, :, :T0] = v
                return _dense_masked_attention(q, k, v, mask, scale)
            x = block(lp, x, lambda q, k: apply_rope(q, k, cos, sin),
                      attend)
        return cache, final_logits(params, head, x[:, -1])

    def step(params, cache, token, pos):
        layers, head = unstack(params)
        B = token.shape[0]
        lengths, pv = _positions(pos, B, dev)
        x = params["wte"][token][:, None]                   # [B, 1, h]
        if pv is not None:
            cos_t, sin_t = cos_full[pv][:, None], sin_full[pv][:, None]

            def rope(q, k):
                return _rope_rows(q, k, cos_t, sin_t)
        else:
            p = int(pos)
            cos_t, sin_t = cos_full[p:p + 1], sin_full[p:p + 1]

            def rope(q, k):
                return apply_rope(q, k, cos_t, sin_t)
        rows = torch.arange(B, device=dev)
        for i, lp in enumerate(layers):
            def attend(q, k, v, i=i):
                kc, vc = cache["k"][i], cache["v"][i]
                if pv is not None:
                    kc[rows, pv], vc[rows, pv] = k[:, 0], v[:, 0]
                else:
                    kc[:, p], vc[:, p] = k[:, 0], v[:, 0]
                return decode_attention(q[:, 0], kc, vc, lengths, scale)
            x = block(lp, x, rope, attend)
        return cache, final_logits(params, head, x[:, 0])

    def chunk_step(params, cache, toks, pos):
        layers, head = unstack(params)
        B, K1 = toks.shape
        pos_ids, mask, write = _chunk_geometry(pos, B, K1, max_len, dev)
        x = params["wte"][toks]
        if pos_ids.ndim == 2:
            cos, sin = cos_full[pos_ids], sin_full[pos_ids]

            def rope(q, k):
                return _rope_rows(q, k, cos, sin)
        else:
            cos, sin = cos_full[pos_ids], sin_full[pos_ids]

            def rope(q, k):
                return apply_rope(q, k, cos, sin)
        for i, lp in enumerate(layers):
            def attend(q, k, v, i=i):
                kc, vc = cache["k"][i], cache["v"][i]
                write(kc, k)
                write(vc, v)
                return _dense_masked_attention(q, kc, vc, mask, scale)
            x = block(lp, x, rope, attend)
        return cache, final_logits(params, head, x)

    if with_chunk:
        return prefill, step, chunk_step
    return prefill, step


# ------------------------------------------------------------ the rollouts
def _as_ids(input_ids, dev) -> torch.Tensor:
    ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
        input_ids, torch.Tensor) else input_ids)
    if ids.ndim != 2:
        raise ValueError(f"input_ids must be [B, T], got {tuple(ids.shape)}")
    return ids.to(device=dev, dtype=torch.long)


def _generate(decoder_builder: Callable, cfg, params, input_ids,
              max_new_tokens: int, *, temperature: float = 0.0,
              top_k: Optional[int] = None, top_p: Optional[float] = None,
              seed: int = 0, generator: Optional[torch.Generator] = None,
              eos_token_id: Optional[int] = None, device=None,
              **builder_kw) -> torch.Tensor:
    """Prefill, then ``max_new_tokens - 1`` decode steps; rows that have
    fed ``eos_token_id`` emit it from then on.  Sampling draws from
    ``generator``, or, without one, from ``seed``'s key chain as the JAX
    package does (:func:`sample_logits` with ``key``)."""
    dev = resolve_device(device)
    ids = _as_ids(input_ids, dev)
    B, T0 = ids.shape
    if max_new_tokens <= 0:
        return ids
    max_len = T0 + max_new_tokens
    max_pos = getattr(cfg, "max_position_embeddings", None)
    if max_pos is not None and max_len > max_pos:
        raise ValueError(
            f"prompt ({T0}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_position_embeddings ({max_pos}); later positions would "
            f"silently clamp to the last learned position embedding")
    prefill, step = decoder_builder(cfg, max_len, device=dev, **builder_kw)
    # jax.random.key(seed) -> (key0, key_loop); each step splits key_loop
    key0, key_loop = threefry.split(threefry.prng_key(seed))

    def sample(logits, key):
        return sample_logits(logits, generator, temperature=temperature,
                             top_k=top_k, top_p=top_p,
                             key=None if generator is not None else key)
    with torch.inference_mode():
        cache, logits = prefill(params, ids)
        tok = sample(logits, key0)
        toks = [tok]
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(max_new_tokens - 1):
            key_loop, sub = threefry.split(key_loop)
            cache, logits = step(params, cache, tok, T0 + i)
            nxt = sample(logits, sub)
            if eos_token_id is not None:
                done = done | (tok == eos_token_id)
                nxt = torch.where(done, eos_token_id, nxt)
            toks.append(nxt)
            tok = nxt
        return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)


def gpt_generate(params, cfg, input_ids, max_new_tokens: int, **kw):
    """Greedy / sampled generation for the GPT tree: ``[B, T0 +
    max_new_tokens]`` ids (prompt included), int64.  ``kw``:
    ``temperature``, ``top_k``, ``top_p``, ``seed``, ``generator``,
    ``eos_token_id``, ``device``."""
    return _generate(build_gpt_decoder, cfg, params, input_ids,
                     max_new_tokens, **kw)


def llama_generate(params, cfg, input_ids, max_new_tokens: int,
                   quant: Optional[str] = None, **kw):
    """:func:`gpt_generate` for the Llama tree; ``quant``
    "weight_only_int8" / "weight_only_int4" with a tree from
    :func:`quantize_llama_params` (BASELINE config 5's weight-only
    decode)."""
    return _generate(build_llama_decoder, cfg, params, input_ids,
                     max_new_tokens, quant=quant, **kw)


def llama_speculative_generate(params, cfg, draft_params, draft_cfg,
                               input_ids, max_new_tokens: int, *,
                               num_draft: int = 4, device=None):
    return _speculative_generate(build_llama_decoder, params, cfg,
                                 draft_params, draft_cfg, input_ids,
                                 max_new_tokens, num_draft=num_draft,
                                 device=device)


def gpt_speculative_generate(params, cfg, draft_params, draft_cfg,
                             input_ids, max_new_tokens: int, *,
                             num_draft: int = 4, device=None):
    """GPT-family speculative decoding, the contract of
    :func:`llama_speculative_generate`."""
    return _speculative_generate(build_gpt_decoder, params, cfg,
                                 draft_params, draft_cfg, input_ids,
                                 max_new_tokens, num_draft=num_draft,
                                 device=device)


def _speculative_generate(builder, params, cfg, draft_params, draft_cfg,
                          input_ids, max_new_tokens: int, *,
                          num_draft: int = 4, device=None):
    """Greedy speculative decoding (Leviathan et al. 2023, greedy case): a
    draft model proposes ``num_draft`` tokens per round, the target scores
    them in one ``chunk_step`` and accepts the longest matching prefix
    plus its own next token, so the output is the target's greedy rollout
    under the chunked attention.  Rows advance at their own positions;
    rows that finish early ride along with frozen positions.  Returns
    ``([B, T0 + max_new_tokens] ids, stats)``."""
    dev = resolve_device(device)
    ids = _as_ids(input_ids, dev)
    B, T0 = ids.shape
    if max_new_tokens <= 0:
        return ids, {"rounds": 0, "accepted_drafts": 0, "proposed": 0,
                     "accept_rate": 0.0}
    K = int(num_draft)
    max_len = T0 + max_new_tokens + K + 1        # slack for overshoot writes
    for c in (cfg, draft_cfg):
        mp = getattr(c, "max_position_embeddings", None)
        if mp is not None and max_len > mp:
            raise ValueError(
                f"speculative window needs {max_len} positions, config "
                f"allows {mp} (prompt {T0} + new {max_new_tokens} + draft "
                f"slack {K + 1})")
    prefill_t, _, chunk_t = builder(cfg, max_len, with_chunk=True,
                                    device=dev)
    prefill_d, step_d = builder(draft_cfg, max_len, device=dev)
    with torch.inference_mode():
        t_cache, t_logits = prefill_t(params, ids)
        d_cache, _ = prefill_d(draft_params, ids)
        last = torch.argmax(t_logits, -1)
        outs = [[int(t)] for t in last.tolist()]
        pos = np.full((B,), T0, np.int64)        # next unwritten position
        rounds = accepted = proposed = 0
        while any(len(o) < max_new_tokens for o in outs):
            pos_v = torch.as_tensor(pos, device=dev)
            props, dtok = [], last
            for i in range(K):
                d_cache, dl = step_d(draft_params, d_cache, dtok, pos_v + i)
                dtok = torch.argmax(dl, -1)
                props.append(dtok)
            chunk = torch.stack([last] + props, dim=1)       # [B, K+1]
            t_cache, cl = chunk_t(params, t_cache, chunk, pos_v)
            tgt = torch.argmax(cl, -1).cpu().numpy()         # [B, K+1]
            props_np = chunk[:, 1:].cpu().numpy()
            last_np = last.cpu().numpy().copy()
            rounds += 1
            any_full = False
            for b in range(B):
                if len(outs[b]) >= max_new_tokens:
                    continue
                n = 0
                while n < K and props_np[b, n] == tgt[b, n] \
                        and len(outs[b]) + n + 1 < max_new_tokens:
                    n += 1
                any_full = any_full or n == K
                new_toks = props_np[b, :n].tolist() + [int(tgt[b, n])]
                outs[b].extend(new_toks)
                accepted += n
                proposed += K
                pos[b] += n + 1
                last_np[b] = new_toks[-1]
            if any_full:
                # a fully accepted d_K was proposed but never fed to the
                # draft: feed it at old_pos + K so its cache has no hole
                d_cache, _ = step_d(draft_params, d_cache,
                                    torch.as_tensor(props_np[:, K - 1],
                                                    device=dev), pos_v + K)
            last = torch.as_tensor(last_np, device=dev)
        toks = torch.as_tensor([o[:max_new_tokens] for o in outs],
                               dtype=torch.long, device=dev)
    stats = {"rounds": rounds, "accepted_drafts": accepted,
             "proposed": proposed,
             "accept_rate": round(accepted / max(proposed, 1), 4)}
    return torch.cat([ids, toks], dim=1), stats
