"""The one-device Llama train step.

Counterpart of ``paddle_tpu/models/llama.py:build_llama_train_step`` over
the one-stage path of ``paddle_tpu/parallel/manual.py:
build_hybrid_train_step`` with one device (pp = mp = dp = sep = sharding
= 1): embedding row gather, the stacked blocks (each under activation
checkpointing when ``remat``), final RMSNorm, the dense head (fp32 logits,
then ``lse - label_logit`` per token), loss ``sum(nll) / (b * s)``, and
Adam with the law of ``zero_adam_leaf_update`` at one shard.

Attention runs through :func:`..ops.flash_backends.tuned_flash`, which is
the port's flash kernel on CUDA tensors (its plain version on the CPU).
Everything the one-device step does not cover raises
``NotImplementedError`` naming its ROADMAP queue-1 item.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import make_generator, resolve_device
from ..models.llama import (LlamaConfig, _rope_cos_sin, block_apply,
                            init_params, rms_norm, torch_dtype)
from ..ops.flash_backends import tuned_flash

__all__ = ["ADAM_B1", "ADAM_B2", "ADAM_EPS", "vocab_nll", "adam_update",
           "build_llama_train_step"]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8
TOP = ("wte", "head", "lnf_w")          # the leaves outside the blocks


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


def _check_supported(cfg, *, num_microbatches, remat_policy, fused_head,
                     sharding_stage, degrees, cp_mode, sequence_parallel,
                     tp_overlap, offload_optimizer):
    dist = "training runtime and distributed parallelism"
    if fused_head:
        _refuse("fused_head=True (the logits-free linear cross-entropy "
                "head, TPU kernels linear_ce.py:152/253/270); pass "
                "fused_head=False for the dense head", 4,
                "fused linear-CE head")
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


def build_llama_train_step(cfg: LlamaConfig, device=None,
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
                           offload_optimizer: bool = False):
    """``(step_fn, init_fn)`` for one device.

    ``init_fn(seed) -> state`` with ``state = {"params", "opt": {"m", "v",
    "t"}}``: params from :func:`..models.llama.init_params` with a
    generator seeded ``seed``, fp32 zero moments shaped like the params,
    ``t`` an int.  ``step_fn(state, ids, labels) -> (state, loss)`` takes
    ``[b, s]`` int ids and labels (numpy or torch), runs forward and
    backward, and updates params and moments IN PLACE under
    ``torch.no_grad()`` (the returned state is the same dict, ``t`` + 1);
    ``loss`` is a detached fp32 scalar on the device.
    ``step_fn.loss_and_grads(state, ids, labels) -> (loss, grads)`` runs
    the same forward and backward without the update.

    ``use_flash`` True or None: the port's flash kernel (the TPU-tuned
    dense-or-flash policy of ``ops/attention_policy.py`` does not carry
    over); False: the dense ``models.llama._gqa_attention``.  ``remat``
    wraps each layer in ``checkpoint(..., use_reentrant=False)``
    (``parallel/remat.py:remat_wrap`` with no policy).  ``fused_head``
    None reads ``cfg.fused_head``, whose default True is refused: pass
    False or set it in the config."""
    use_fused = cfg.fused_head if fused_head is None else fused_head
    _check_supported(cfg, num_microbatches=num_microbatches,
                     remat_policy=remat_policy, fused_head=use_fused,
                     sharding_stage=sharding_stage,
                     degrees=dict(dp=dp, mp=mp, pp=pp, sep=sep,
                                  sharding=sharding),
                     cp_mode=cp_mode, sequence_parallel=sequence_parallel,
                     tp_overlap=tp_overlap,
                     offload_optimizer=offload_optimizer)
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    attn = _attention(use_flash)
    eps = cfg.rms_norm_eps

    def init_fn(seed: int = 0):
        params = init_params(cfg, make_generator(seed, dev), device=dev)

        def zeros(tree):
            return {k: zeros(x) if isinstance(x, dict) else
                    torch.zeros(x.shape, dtype=torch.float32, device=dev)
                    for k, x in tree.items()}
        return {"params": params,
                "opt": {"m": zeros(params), "v": zeros(params), "t": 0}}

    def loss_fn(wte, head, lnf_w, layers, ids, labels):
        b, s = ids.shape
        cos, sin = _rope_cos_sin(s, cfg.head_dim, cfg.rope_theta, dt,
                                 cfg.rope_scaling, device=dev, dynamic=True)
        x = wte[ids]
        for lp in layers:
            if remat:
                x = checkpoint(block_apply, lp, x, cfg, cos, sin, attn,
                               use_reentrant=False)
            else:
                x = block_apply(lp, x, cfg, cos, sin, attn)
        logits = rms_norm(x, lnf_w, eps).float() @ head.float()
        return vocab_nll(logits, labels).sum() / (b * s)

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
        leaf = {k: p[k].detach().requires_grad_(True) for k in TOP}
        leaf["blocks"] = {n: [w.detach().requires_grad_(True) for w in ws]
                          for n, ws in p["blocks"].items()}
        layers = [dict(zip(leaf["blocks"], ws))
                  for ws in zip(*leaf["blocks"].values())]
        loss = loss_fn(leaf["wte"], leaf["head"], leaf["lnf_w"], layers,
                       ids, labels)
        loss.backward()
        return loss.detach(), leaf

    def loss_and_grads(state, ids, labels):
        """``(loss, grads)`` without an update; grads in the params tree
        layout (blocks stacked ``[L, ...]``)."""
        loss, leaf = backward(state, ids, labels)
        grads = {k: leaf[k].grad for k in TOP}
        grads["blocks"] = {n: torch.stack([w.grad for w in ws])
                           for n, ws in leaf["blocks"].items()}
        return loss, grads

    def step_fn(state, ids, labels):
        loss, leaf = backward(state, ids, labels)
        t = int(state["opt"]["t"]) + 1
        p, m, v = state["params"], state["opt"]["m"], state["opt"]["v"]
        for k in TOP:
            adam_update(p[k], leaf[k].grad, m[k], v[k], t, learning_rate)
        for n, ws in leaf["blocks"].items():
            for i, w in enumerate(ws):
                adam_update(p["blocks"][n][i], w.grad, m["blocks"][n][i],
                            v["blocks"][n][i], t, learning_rate)
        state["opt"]["t"] = t
        return state, loss

    step_fn.loss_and_grads = loss_and_grads
    return step_fn, init_fn

