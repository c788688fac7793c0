"""Flash-attention backend dispatch: counterpart of
``paddle_tpu/ops/pallas/flash_backends.py``.

The JAX package picks per shape among three backends: ``ours`` (this
repository's kernel), ``jax_flash`` and ``splash`` (kernels that ship inside
JAX).  Only ``ours`` is a kernel of this repository, so it is the port's
only backend: :func:`tuned_flash` and ``run_backend("ours", ...)`` call
:func:`.flash_attention.flash_attention`, and the other two names raise
``NotImplementedError``.  The port's kernel has one configuration, so
there is no autotuner.
"""

from __future__ import annotations

import math
from typing import Optional

from .flash_attention import flash_attention

__all__ = ["BACKENDS", "run_backend", "tuned_flash"]

BACKENDS = ("ours",)
_JAX_ONLY = {"jax_flash": "jax.experimental.pallas.ops.tpu.flash_attention",
             "splash": "jax.experimental.pallas.ops.tpu.splash_attention"}


def run_backend(name, q, k, v, scale, causal, seg_q=None, seg_k=None,
                bias=None):
    """Attention through the named backend, ``[B, S, H, D]`` layout."""
    if name == "ours":
        return flash_attention(q, k, v, scale, causal, segment_ids=seg_q,
                               kv_segment_ids=seg_k, bias=bias)
    if name in _JAX_ONLY:
        raise NotImplementedError(
            f"flash backend {name!r} wraps a kernel that ships inside JAX "
            f"({_JAX_ONLY[name]}), not a kernel of this repository; the "
            f"port runs backend 'ours'")
    raise ValueError(f"unknown flash backend {name!r}; one of "
                     f"{BACKENDS + tuple(_JAX_ONLY)}")


def tuned_flash(q, k, v, scale: Optional[float] = None, causal: bool = False,
                segment_ids=None, kv_segment_ids=None, bias=None):
    """Drop-in for ``flash_attention``: backend ``ours``, always."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    return run_backend("ours", q, k, v, s, causal, segment_ids,
                       kv_segment_ids, bias)
