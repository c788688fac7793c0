"""The decode-attention kernel on the card (``kernels/csrc/
decode_attention.cu``): one query token per sequence against its cache
rows ``[0, lengths[b])``.

The wrapper checks its tensors and launches one kernel on the current
stream; it takes CUDA tensors only and raises on what the kernel does not
take (head_dim other than 64 or 128, more than 8 query heads per kv head,
a dtype other than float32 / bfloat16, a cache whose last two dims are
not contiguous or whose batch and row strides are not multiples of 16
bytes).  The cache is read in place through its batch and row strides,
so a layer's slice ``cache[l]`` of the generation cache is passed
without a copy.  The kernel splits each (sequence, kv head)'s rows over
a thread-block cluster; a launch the card refuses raises.
"""

from __future__ import annotations

import torch

from ...kernels import build
from . import layer

__all__ = ["HEAD_DIMS", "MAX_GROUP", "decode_attention_cuda"]

HEAD_DIMS = (64, 128)
MAX_GROUP = 8


def decode_attention_cuda(q, k_cache, v_cache, lengths, scale: float):
    """``[B, Hq, D]`` from q ``[B, Hq, D]``, caches ``[B, T, Hkv, D]``
    and ``lengths`` ``[B]``."""
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError("decode_attention: the kernel needs CUDA tensors")
    dt, dev = q.dtype, q.device
    code = layer.dtype_code(dt)
    B, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention takes head_dim "
                         f"{' or '.join(map(str, HEAD_DIMS))}, got {D}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention takes up to {MAX_GROUP} q heads "
                         f"per kv head, got {Hq} / {Hkv}")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.device != dev or c.dtype != dt:
            raise ValueError(f"{name} is {c.dtype} on {c.device}, q is {dt} "
                             f"on {dev}")
        if c.stride(3) != 1 or c.stride(2) != D:
            raise ValueError(f"{name}'s [Hkv, D] dims must be contiguous, "
                             f"strides {c.stride()}")
        if c.data_ptr() % 16 or any(c.stride(i) * c.element_size() % 16
                                    for i in (0, 1)):
            raise ValueError(f"{name} must be 16-byte aligned, with batch "
                             f"and row strides of a multiple of 16 bytes; "
                             f"strides {c.stride()}")
    if k_cache.stride() != v_cache.stride():
        raise ValueError(f"k and v caches need one layout, strides "
                         f"{k_cache.stride()} and {v_cache.stride()}")
    q = layer.check_tensor(q.contiguous(), "q", (B, Hq, D), dt, dev)
    lengths = layer.check_tensor(
        lengths.to(device=dev, dtype=torch.int32).contiguous(), "lengths",
        (B,), torch.int32, dev)
    out = torch.empty((B, Hq, D), dtype=dt, device=dev)
    build.check(build.library().pt_decode_attention(
        code, B, Hq, Hkv, D, T, k_cache.stride(0), k_cache.stride(1),
        float(scale), q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), layer.stream_handle()),
        "pt_decode_attention")
    return out
