"""The one-device Llama and GPT train steps.

Counterparts of ``paddle_tpu/models/llama.py:build_llama_train_step`` and
``paddle_tpu/models/gpt.py:build_gpt_train_step`` over the one-stage path
of ``paddle_tpu/parallel/manual.py:build_hybrid_train_step`` with one
device (pp = mp = dp = sep = sharding = 1).  Both models share one loop
(:func:`_one_device_step`), split as the JAX step is into ``embed_fn``,
``block_fn`` and ``head_nll_fn``: the embedding, the stacked blocks (each
under activation checkpointing when ``remat``), the head's per-token NLL,
loss ``sum(nll) / (b * s)``, and Adam with the law of
``zero_adam_leaf_update`` at one shard.

The head is the logits-free fused linear cross-entropy
(:func:`..ops.fused_cross_entropy.linear_cross_entropy`, the port's
linear-CE kernels on CUDA tensors) when ``fused_head`` (the configs'
default), else the dense one (fp32 logits, then ``lse - label_logit`` per
token).  Attention runs through :func:`..ops.flash_backends.tuned_flash`,
the port's flash kernels on CUDA tensors.  On CPU tensors every op runs
its plain version.  Everything the one-device step does not cover raises
``NotImplementedError`` naming its ROADMAP queue-1 item.

Both builders return ``(step_fn, init_fn)``.
``init_fn(seed) -> state`` with ``state = {"params", "opt": {"m", "v",
"t"}}``: params from the model's ``init_params`` with a generator
seeded ``seed``, fp32 zero moments shaped like the params, ``t`` an
int.  ``step_fn(state, ids, labels) -> (state, loss)`` takes ``[b, s]``
int ids and labels (numpy or torch), runs forward and backward, and
updates params and moments IN PLACE under ``torch.no_grad()`` (the
returned state is the same dict, ``t`` + 1); ``loss`` is a detached
fp32 scalar on the device.  ``step_fn.loss_and_grads(state, ids,
labels) -> (loss, grads)`` runs the same forward and backward without
the update.

``use_flash`` True or None: the port's flash kernels (the TPU-tuned
dense-or-flash policy of ``ops/attention_policy.py`` does not carry
over); False: the model's dense attention.  ``remat`` wraps each layer
in ``checkpoint(..., use_reentrant=False)``
(``parallel/remat.py:remat_wrap`` with no policy).  ``fused_head`` None
reads ``cfg.fused_head`` (default True: the logits-free linear-CE
head); ``head_chunk`` is its vocab chunk width (default
``ops.fused_cross_entropy.default_chunk``).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import make_generator, resolve_device
from ..models import gpt, llama
from ..ops.flash_backends import tuned_flash
from ..ops.fused_cross_entropy import linear_cross_entropy

__all__ = ["ADAM_B1", "ADAM_B2", "ADAM_EPS", "vocab_nll", "adam_update",
           "build_llama_train_step", "build_gpt_train_step"]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8


def _refuse(what: str, item: int, name: str):
    raise NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP queue 1 "
        f"item {item}: {name})")


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token ``lse - label_logit`` over fp32 logits ``[..., V]`` (the
    JAX ``vocab_parallel_nll`` at mp = 1; the max shift carries no
    gradient)."""
    z = logits - logits.detach().amax(-1, keepdim=True)
    lse = torch.log(torch.exp(z).sum(-1))
    return lse - torch.gather(z, -1, labels[..., None])[..., 0]


@torch.no_grad()
def adam_update(p, g, m, v, t: int, lr: float, b1: float = ADAM_B1,
                b2: float = ADAM_B2, eps: float = ADAM_EPS) -> None:
    """One Adam step for one leaf, IN PLACE on ``p``, ``m`` and ``v``: fp32
    moments, bias correction by step ``t`` (1-based, reckoned in fp32), no
    weight decay; the update is computed in fp32 on an fp32 copy of the
    param and rounded back to its dtype."""
    tf = torch.tensor(float(t), dtype=torch.float32)
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** tf)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** tf)
    g = g.float()
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * g * g)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    p.copy_((p.float() - lr * upd).to(p.dtype))


def _attention(use_flash):
    if use_flash is None or use_flash is True:
        return functools.partial(tuned_flash, causal=True)
    if use_flash is False:
        return None
    raise ValueError(f"use_flash must be True, False or None, got "
                     f"{use_flash!r}")


def _check_supported(cfg, *, num_microbatches, remat_policy, sharding_stage,
                     degrees, cp_mode, sequence_parallel, tp_overlap,
                     offload_optimizer):
    dist = "training runtime and distributed parallelism"
    if cfg.moe_num_experts:
        _refuse("mixture-of-experts FFNs", 15, "MoE")
    for axis, n in degrees.items():
        if n != 1:
            _refuse(f"{axis}={n} (a multi-device topology)", 17, dist)
    if cp_mode is not None:
        _refuse(f"cp_mode={cp_mode!r} (context parallelism)", 6,
                "ring / Ulysses attention")
    for flag, on in (("num_microbatches > 1", num_microbatches != 1),
                     ("sequence_parallel", sequence_parallel),
                     ("tp_overlap", tp_overlap),
                     ("offload_optimizer", offload_optimizer),
                     ("sharding_stage=3", sharding_stage == 3),
                     (f"remat_policy={remat_policy!r}",
                      remat_policy is not None)):
        if on:
            _refuse(flag, 17, dist)
    if sharding_stage != 2:
        raise ValueError(f"sharding_stage must be 2 or 3, got "
                         f"{sharding_stage}")


def _one_device_step(dev, init_params_fn, embed_fn, block_fn, head_nll_fn,
                     learning_rate: float, remat: bool, step_ctx_fn=None):
    """``(step_fn, init_fn)`` of the shared one-device loop.

    ``init_params_fn(generator)`` makes the params tree: top-level leaves
    and ``"blocks"``, a dict of ``[L, ...]`` stacks.  Per step,
    ``ctx = step_ctx_fn(s)`` (None without one), ``x = embed_fn(leaves,
    ids)``, ``x = block_fn(layer, x, ctx)`` for each layer (under
    ``checkpoint(..., use_reentrant=False)`` when ``remat``), and the loss
    is ``head_nll_fn(leaves, x, labels).sum() / (b * s)``."""

    def init_fn(seed: int = 0):
        params = init_params_fn(make_generator(seed, dev))

        def zeros(tree):
            return {k: zeros(x) if isinstance(x, dict) else
                    torch.zeros(x.shape, dtype=torch.float32, device=dev)
                    for k, x in tree.items()}
        return {"params": params,
                "opt": {"m": zeros(params), "v": zeros(params), "t": 0}}

    def tokens(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a))
        return a.to(device=dev, dtype=torch.long)

    def backward(state, ids, labels):
        """Loss, and the leaves it was differentiated in (``.grad`` set):
        views of the stored params, one per layer for each stacked block
        leaf."""
        ids, labels = tokens(ids), tokens(labels)
        p = state["params"]
        leaf = {k: v.detach().requires_grad_(True) for k, v in p.items()
                if k != "blocks"}
        leaf["blocks"] = {n: [w.detach().requires_grad_(True) for w in ws]
                          for n, ws in p["blocks"].items()}
        layers = [dict(zip(leaf["blocks"], ws))
                  for ws in zip(*leaf["blocks"].values())]
        b, s = ids.shape
        ctx = step_ctx_fn(s) if step_ctx_fn is not None else None
        x = embed_fn(leaf, ids)
        for lp in layers:
            if remat:
                x = checkpoint(block_fn, lp, x, ctx, use_reentrant=False)
            else:
                x = block_fn(lp, x, ctx)
        loss = head_nll_fn(leaf, x, labels).sum() / (b * s)
        loss.backward()
        return loss.detach(), leaf

    def loss_and_grads(state, ids, labels):
        """``(loss, grads)`` without an update; grads in the params tree
        layout (blocks stacked ``[L, ...]``)."""
        loss, leaf = backward(state, ids, labels)
        grads = {k: w.grad for k, w in leaf.items() if k != "blocks"}
        grads["blocks"] = {n: torch.stack([w.grad for w in ws])
                           for n, ws in leaf["blocks"].items()}
        return loss, grads

    def step_fn(state, ids, labels):
        loss, leaf = backward(state, ids, labels)
        t = int(state["opt"]["t"]) + 1
        p, m, v = state["params"], state["opt"]["m"], state["opt"]["v"]
        for k, w in leaf.items():
            if k != "blocks":
                adam_update(p[k], w.grad, m[k], v[k], t, learning_rate)
        for n, ws in leaf["blocks"].items():
            for i, w in enumerate(ws):
                adam_update(p["blocks"][n][i], w.grad, m["blocks"][n][i],
                            v["blocks"][n][i], t, learning_rate)
        state["opt"]["t"] = t
        return state, loss

    step_fn.loss_and_grads = loss_and_grads
    return step_fn, init_fn


def build_llama_train_step(cfg: llama.LlamaConfig, device=None,
                           num_microbatches: int = 1,
                           learning_rate: float = 1e-4,
                           use_flash: Optional[bool] = True,
                           remat: bool = True, remat_policy=None,
                           fused_head: Optional[bool] = None,
                           sharding_stage: int = 2, *, dp: int = 1,
                           mp: int = 1, pp: int = 1, sep: int = 1,
                           sharding: int = 1, cp_mode: Optional[str] = None,
                           sequence_parallel: bool = False,
                           tp_overlap: bool = False,
                           offload_optimizer: bool = False,
                           head_chunk: Optional[int] = None):
    """``(step_fn, init_fn)`` (module docstring) of the Llama step on one
    device: embedding
    row gather, the blocks with RoPE tables built at the step's length,
    final RMSNorm, and the untied ``[H, V]`` head (fused:
    ``linear_cross_entropy(x, head, labels, w_layout="hv")``)."""
    _check_supported(cfg, num_microbatches=num_microbatches,
                     remat_policy=remat_policy,
                     sharding_stage=sharding_stage,
                     degrees=dict(dp=dp, mp=mp, pp=pp, sep=sep,
                                  sharding=sharding),
                     cp_mode=cp_mode, sequence_parallel=sequence_parallel,
                     tp_overlap=tp_overlap,
                     offload_optimizer=offload_optimizer)
    use_fused = cfg.fused_head if fused_head is None else fused_head
    dev = resolve_device(device)
    dt = llama.torch_dtype(cfg.dtype)
    attn = _attention(use_flash)
    eps = cfg.rms_norm_eps

    def step_ctx_fn(s):
        return llama._rope_cos_sin(s, cfg.head_dim, cfg.rope_theta, dt,
                                   cfg.rope_scaling, device=dev,
                                   dynamic=True)

    def embed_fn(p, ids):
        return p["wte"][ids]

    def block_fn(lp, x, ctx):
        return llama.block_apply(lp, x, cfg, ctx[0], ctx[1], attn)

    def head_nll_fn(p, x, labels):
        x = llama.rms_norm(x, p["lnf_w"], eps)
        if use_fused:
            return linear_cross_entropy(x, p["head"], labels, w_layout="hv",
                                        chunk=head_chunk)
        return vocab_nll(x.float() @ p["head"].float(), labels)

    return _one_device_step(
        dev, lambda g: llama.init_params(cfg, g, device=dev), embed_fn,
        block_fn, head_nll_fn, learning_rate, remat, step_ctx_fn)


def build_gpt_train_step(cfg: gpt.GPTConfig, device=None,
                         num_microbatches: int = 1,
                         learning_rate: float = 1e-4,
                         cp_mode: Optional[str] = None,
                         use_flash: Optional[bool] = None,
                         remat: bool = True, remat_policy=None,
                         sharding_stage: int = 2,
                         offload_optimizer: bool = False,
                         sequence_parallel: bool = False,
                         tp_overlap: bool = False,
                         fused_head: Optional[bool] = None,
                         head_chunk: Optional[int] = None, *, dp: int = 1,
                         mp: int = 1, pp: int = 1, sep: int = 1,
                         sharding: int = 1):
    """``(step_fn, init_fn)`` (module docstring) of the GPT step on one
    device: ``wte[ids] +
    wpe[:s]``, the blocks, the final LayerNorm (fp32 gains, so its output is
    fp32 under a bf16 config, as in the JAX package), and the head tied to
    ``wte`` (fused: ``linear_cross_entropy(x, wte, labels,
    w_layout="vh")``); wte's grad sums its embedding and head parts."""
    _check_supported(cfg, num_microbatches=num_microbatches,
                     remat_policy=remat_policy,
                     sharding_stage=sharding_stage,
                     degrees=dict(dp=dp, mp=mp, pp=pp, sep=sep,
                                  sharding=sharding),
                     cp_mode=cp_mode, sequence_parallel=sequence_parallel,
                     tp_overlap=tp_overlap,
                     offload_optimizer=offload_optimizer)
    use_fused = cfg.fused_head if fused_head is None else fused_head
    dev = resolve_device(device)
    attn = _attention(use_flash)

    def embed_fn(p, ids):
        s = ids.shape[1]
        if s > cfg.max_position_embeddings:
            raise ValueError(f"sequence length {s} exceeds "
                             f"max_position_embeddings "
                             f"{cfg.max_position_embeddings}")
        return p["wte"][ids] + p["wpe"][:s][None]

    def block_fn(lp, x, ctx):
        return gpt.block_apply(lp, x, cfg, attn)

    def head_nll_fn(p, x, labels):
        x = gpt.layer_norm(x, p["lnf_w"], p["lnf_b"], cfg.layer_norm_eps)
        if use_fused:
            return linear_cross_entropy(x, p["wte"], labels, w_layout="vh",
                                        chunk=head_chunk)
        return vocab_nll(x.float() @ p["wte"].float().t(), labels)

    return _one_device_step(
        dev, lambda g: gpt.init_params(cfg, g, device=dev), embed_fn,
        block_fn, head_nll_fn, learning_rate, remat)

