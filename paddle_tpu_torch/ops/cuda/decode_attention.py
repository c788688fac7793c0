"""The decode-attention kernel on the card (``kernels/csrc/
decode_attention.cu``): one query token per sequence against its cache
rows ``[0, lengths[b])``.

The wrapper checks its tensors and launches one kernel on the current
stream; it takes CUDA tensors only and raises on what the kernel does not
take: head_dim other than 64 or 128, more than 8 query heads per kv head,
a cache whose last dim is not contiguous or whose batch, row and head
strides are not multiples of 16 bytes, or k and v of two layouts raise
``ValueError``; a q whose dtype differs from the cache's (fp32 q over a
bf16 cache, as MMHA gives after ``qkv_out_scale``) and a float16 cache
have no kernel instance and raise ``NotImplementedError`` (ROADMAP queue
2 A item 6).  The cache ``[B, T, Hkv, D]`` is read in place through its
batch, row and head strides, so a layer's slice ``cache[l]`` of the
generation cache and the head-major view ``cache_kv[0].transpose(1, 2)``
of Paddle's MMHA cache ``[2, B, H, T_max, D]`` are passed without a copy.
The kernel splits each (sequence, kv head)'s rows over a thread-block
cluster; a launch the card refuses raises.
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
    (any strides with a contiguous last dim) and ``lengths`` ``[B]``."""
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError("decode_attention: the kernel needs CUDA tensors")
    dt, dev = q.dtype, q.device
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.device != dev:
            raise ValueError(f"{name} is on {c.device}, q on {dev}")
        if c.dtype != dt or dt not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"decode_attention: q {dt} over a {c.dtype} cache has no "
                f"kernel instance (the kernel takes q and cache of one "
                f"dtype, float32 or bfloat16; ROADMAP queue 2 A item 6)")
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
        if c.stride(3) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous, "
                             f"strides {c.stride()}")
        if c.data_ptr() % 16 or any(c.stride(i) * c.element_size() % 16
                                    for i in (0, 1, 2)):
            raise ValueError(f"{name} must be 16-byte aligned, with batch, "
                             f"row and head strides of a multiple of 16 "
                             f"bytes; strides {c.stride()}")
    if k_cache.stride() != v_cache.stride():
        raise ValueError(f"k and v caches need one layout, strides "
                         f"{k_cache.stride()} and {v_cache.stride()}")
    q = layer.check_tensor(q.contiguous(), "q", (B, Hq, D), dt, dev)
    lengths = layer.check_tensor(
        lengths.to(device=dev, dtype=torch.int32).contiguous(), "lengths",
        (B,), torch.int32, dev)
    out = torch.empty((B, Hq, D), dtype=dt, device=dev)
    sb, st, sh = k_cache.stride(0), k_cache.stride(1), k_cache.stride(2)
    build.check(build.library().pt_decode_attention(
        code, B, Hq, Hkv, D, T, sb, st, sh, float(scale), q.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), layer.stream_handle()), "pt_decode_attention")
    return out
