"""CUDA wrapper of the ``prefill_block`` op.

Replaces the TPU megakernel ``paddle_tpu/ops/pallas/prefill_block.py``
(``prefill_block_pallas``, ``pallas_call`` at :435, body ``_kernel``):
one Llama or GPT layer for a ``[Ts, H]`` prompt chunk of one sequence starting
at position ``start``, causal over the committed pages plus the chunk.

What bounds it on an H100: at Ts = 16 the weight bytes (as decode); at
Ts = 256 the tensor-core operations of the GEMMs (2 x 256 x 202 M per 7B
layer against ~405 MB of weights is past the card's ~295 op/byte ridge).
The chain is the decode op's (``pt_prefill_block`` in
``kernels/csrc/layer.cu``): the GEMMs take 64 x 64 tensor-core tiles for
Ts > 16, the attention walks each row's own positions only.  Rows whose
``blk`` lies outside the pool (a bucket's padded tail) write nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional

from ...kernels import build
from . import layer

__all__ = ["prefill_block_cuda"]


def prefill_block_cuda(x, lp, pool_k, pool_v, blk, off, bt_row, cos, sin, *,
                       spec, start: int, scale: Optional[float] = None):
    """``x`` [1, Ts, H] CUDA tensor; see ``ops.decode_block.prefill_block``.
    Writes the chunk's K/V into the pools in place and returns
    ``(x_out [1, Ts, H], pool_k, pool_v)``."""
    if x.ndim != 3 or x.shape[0] != 1:
        raise ValueError(f"prefill_block: x must be [1, Ts, H], got "
                         f"{tuple(x.shape)}")
    s = scale if scale is not None else 1.0 / (spec.head_dim ** 0.5)
    a, t = layer.layer_args(
        pool_k, pool_v, bt_row, M=x.shape[1], blk=blk, off=off,
        start=int(start), scale=s, spec=spec, x=x[0], lp=lp,
        cos=cos if spec.rope else None, sin=sin if spec.rope else None)
    lib = build.library()
    build.check(lib.pt_prefill_block(ctypes.byref(a), layer.stream_handle()),
                "pt_prefill_block")
    return t["out"][None], pool_k, pool_v
