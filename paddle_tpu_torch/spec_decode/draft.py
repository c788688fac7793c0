"""The draft model: a windowed dense-recompute Llama forward
(counterpart of ``paddle_tpu/spec_decode/draft.py``).

Proposing K tokens per engine step must not introduce per-request
state (a draft KV pool would need its own paging, rollback, and leak
accounting).  So the draft is STATELESS: each proposal re-runs a small
dense forward over the last ``window`` tokens of prompt+output,
right-aligned in a fixed ``[max_batch, window]`` buffer.  Recompute is
the right trade at draft scale: the draft exists because it is small,
and ``window`` is small (default 16), so a proposal costs one [B, W]
forward.

The window is assembled host-side (``assemble_windows``): row ``b``
holds the last ``min(ctx_b, W)`` tokens right-aligned, zero-padded on
the left; positions and the causal+validity mask come from ``ctx_lens``
on the device, so RoPE phases match the tokens' ABSOLUTE positions (a
left-truncated window still rotates token t by angle(t)).

The JAX draft is a jnp chain with no Pallas kernel, so this one is torch
ops on both devices: the engine's norm / SwiGLU closures
(``ops.decode_block.make_norm_ffn``), ``torch.matmul`` products and the
dense masked attention of ``models.generation``.  It is always full
width, whatever the target engine's quantization.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.generation import _dense_masked_attention, _Unstacked
from ..models.llama import _rope_cos_sin, block_shapes, torch_dtype
from ..ops.decode_block import make_norm_ffn, rotate_half

__all__ = ["build_draft_program", "assemble_windows", "check_draft_params"]


def check_draft_params(cfg, params, device) -> None:
    """The draft tree must be dense Llama weights of ``cfg`` in
    ``cfg.dtype`` on ``device`` (blocks ``[L, ...]``)."""
    dt = torch_dtype(cfg.dtype)
    want = {"wte": (cfg.vocab_size, cfg.hidden_size),
            "head": (cfg.hidden_size, cfg.vocab_size),
            "lnf_w": (cfg.hidden_size,)}
    got = {k: params[k] for k in want}
    for name, shape in block_shapes(cfg).items():
        want[f"blocks.{name}"] = (cfg.num_layers,) + shape
        if name not in params["blocks"]:
            raise ValueError(f"draft params[blocks.{name}] is missing (the "
                             "draft is a full-width dense Llama tree)")
        got[f"blocks.{name}"] = params["blocks"][name]
    for key, shape in want.items():
        t = got[key]
        if tuple(t.shape) != shape:
            raise ValueError(
                f"draft params[{key}] has shape {tuple(t.shape)}, expected "
                f"{shape} (a JAX tree goes through bridge.params_from_numpy)")
        if t.dtype != dt or t.device != device:
            raise ValueError(f"draft params[{key}] is {t.dtype} on "
                             f"{t.device}, the draft runs {dt} on {device}")


def build_draft_program(cfg, window: int, device=None):
    """Returns ``draft(params, win [B, W] int, ctx_lens [B] int) ->
    proposals [B] int64`` on ``device`` (default CUDA): the greedy next
    token at each row's last valid slot.  The argmax runs on the device,
    so only ``[B]`` ints cross to the host per proposal, not ``[B, V]``
    logits; ``draft.logits`` is the same forward returning the fp32
    ``[B, V]`` logits.  Rows with ``ctx_lens == 0`` (inactive engine
    slots) produce garbage tokens the scheduler never reads; so do rows
    whose window runs past ``max_position_embeddings`` (their positions
    clamp to the table's end; the JAX take fills NaN there), which only
    propose tokens past every request's budget."""
    if getattr(cfg, "moe_num_experts", 0):
        raise NotImplementedError(
            "MoE draft configs are not ported yet — ROADMAP.md queue 1 "
            "item 15b")
    dev = resolve_device(device)
    W = window
    H, Hkv, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    cos_full, sin_full = _rope_cos_sin(
        cfg.max_position_embeddings, D, cfg.rope_theta,
        torch_dtype(cfg.dtype), getattr(cfg, "rope_scaling", None),
        device=dev)
    scale = 1.0 / (D ** 0.5)
    rms, ffn = make_norm_ffn(cfg)
    unstack = _Unstacked("head", transpose=False)
    slot = torch.arange(W, device=dev)
    causal = torch.ones((W, W), dtype=torch.bool, device=dev).tril()
    last_pos = cfg.max_position_embeddings - 1

    def logits(params, win, ctx_lens):
        layers, head = unstack(params)
        B = win.shape[0]
        ctx = ctx_lens.to(dev, torch.long)[:, None]
        # slot i of the window holds absolute position ctx - W + i; pad
        # slots clamp to 0 and are masked out below
        pos = (ctx - W + slot[None]).clamp(0, last_pos)         # [B, W]
        valid = slot[None] >= (W - ctx)
        x = params["wte"][win.to(dev, torch.long)]              # [B, W, h]
        cos = cos_full[pos][:, :, None, :]                      # [B,W,1,D]
        sin = sin_full[pos][:, :, None, :]
        # causal within the window AND both ends valid
        mask = (causal[None, None] & valid[:, None, None, :]
                & valid[:, None, :, None])                      # [B,1,W,W]

        def rope(t):                                            # [B,W,*,D]
            return t * cos + rotate_half(t) * sin

        for lp in layers:
            y = rms(x, lp["ln1_w"])
            q = (y @ lp["q_w"]).reshape(B, W, H, D)
            k = (y @ lp["k_w"]).reshape(B, W, Hkv, D)
            v = (y @ lp["v_w"]).reshape(B, W, Hkv, D)
            attn = _dense_masked_attention(rope(q), rope(k), v, mask, scale)
            x = x + attn.reshape(B, W, -1) @ lp["o_w"]
            x = x + ffn(lp, rms(x, lp["ln2_w"]))
        xf = rms(x[:, -1], params["lnf_w"])                     # last slot
        return xf.float() @ head

    def draft(params, win, ctx_lens):
        return torch.argmax(logits(params, win, ctx_lens), -1)

    draft.logits = logits
    return draft


def assemble_windows(seqs: Sequence[Sequence[int]], window: int,
                     max_batch: int) -> tuple:
    """Host-side window packing: ``(win [max_batch, W] int32,
    ctx_lens [max_batch] int32)`` from per-slot token sequences (empty
    sequence = inactive slot)."""
    win = np.zeros((max_batch, window), np.int32)
    ctx = np.zeros((max_batch,), np.int32)
    for b, seq in enumerate(seqs):
        n = len(seq)
        ctx[b] = n
        if n == 0:
            continue
        tail: List[int] = list(seq[-window:])
        win[b, window - len(tail):] = np.asarray(tail, np.int32)
    return win, ctx
