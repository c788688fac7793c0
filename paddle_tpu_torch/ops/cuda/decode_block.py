"""CUDA wrapper of the ``decode_block`` op.

Replaces the TPU megakernel ``paddle_tpu/ops/pallas/decode_block.py``
(``decode_block_pallas``, ``pallas_call`` at :535, body ``_kernel``):
one Llama or GPT layer for one decode token per sequence over the paged
pool.

What bounds it on an H100: bytes.  At B <= 8 a 7B layer streams ~405 MB
of bf16 weights and each sequence's live KV rows once; the operations
are ~2 x B x 202 M, far under the tensor cores' rate.  The TPU kernel
kept the whole layer in VMEM, which a 7B layer cannot do in 227 KB of
shared memory, so here one C entry point (``pt_decode_block``) launches
a chain of hand-written kernels that stream the weights once per GEMM
(``kernels/csrc/layer.cu``).  The residual stream's round trips between
the kernels are a few KB per row, small next to the weights.  A GPT-125M
layer streams ~14.2 MB of bf16 weights, a 4.2 us bound at the data sheet's
3.35 TB/s, which is of the order of its 8 launches' fixed cost (PERF.md
section 6 holds the measured times).
"""

from __future__ import annotations

import ctypes
import math

from ...kernels import build
from . import layer

__all__ = ["decode_block_cuda"]


def decode_block_cuda(x, lp, pool_k, pool_v, block_table, lengths, cos, sin,
                      *, spec):
    """``x`` [B, H] CUDA tensor; see ``ops.decode_block.decode_block``.
    Writes the new token's K/V into the pools in place and returns
    ``(x_out, pool_k, pool_v)``."""
    a, t = layer.layer_args(
        pool_k, pool_v, block_table, M=x.shape[0], lengths=lengths,
        scale=1.0 / math.sqrt(spec.head_dim), spec=spec, x=x, lp=lp,
        cos=cos if spec.rope else None, sin=sin if spec.rope else None)
    lib = build.library()
    build.check(lib.pt_decode_block(ctypes.byref(a), layer.stream_handle()),
                "pt_decode_block")
    return t["out"], pool_k, pool_v
