"""The incubate softmax calls: ``softmax_mask_fuse`` and
``softmax_mask_fuse_upper_triangle``.

Counterparts of ``paddle_tpu/incubate/extras.py:81-105``.
``softmax_mask_fuse`` is ``ops.fused.fused_softmax_mask`` (kernel 17 on
the card, its plain version on the CPU; no gradient, as in JAX).
``softmax_mask_fuse_upper_triangle`` is a torch-op chain, as the JAX call
is a jnp chain: -1e30 above the diagonal, softmax in fp32, x's dtype.
"""

from __future__ import annotations

import torch

from ..ops import fused as _fused

__all__ = ["softmax_mask_fuse", "softmax_mask_fuse_upper_triangle"]


def softmax_mask_fuse(x, mask, name=None):
    """``softmax(x + mask)`` over the last axis, mask broadcastable to x."""
    return _fused.fused_softmax_mask(x, mask)


def softmax_mask_fuse_upper_triangle(x):
    """Causal softmax over the last axis of ``x [..., s_q, s_k]``: key j of
    query i is kept where ``j <= i``."""
    s_q, s_k = x.shape[-2], x.shape[-1]
    tri = torch.ones((s_q, s_k), dtype=torch.bool, device=x.device).tril()
    logits = torch.where(tri, x.float(), -1e30)
    return torch.softmax(logits, -1).to(x.dtype)
