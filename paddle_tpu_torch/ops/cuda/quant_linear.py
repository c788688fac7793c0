"""The weight-only matmul kernels on the card (``kernels/csrc/
quant_linear.cu``): ``x @ dequant(codes, scale)`` with int8 or packed int4
codes, per-channel or grouped fp32 scales.

One wrapper launches one kernel on the current stream; the library picks
it from x's dtype and rows: bf16 x with M <= 16 rows takes the decode
kernel (``wo_int8_small_m`` / ``wo_int4_small_m``: ``wo_dec``, 8 or 16 x
rows, K split over a cluster sized from the card's residency), more rows
the prefill kernel (``wo_int8_tiled`` / ``wo_int4_tiled``: ``wo_wgmma``);
both run wgmma with the widened codes as its register operand, x and the
codes by TMA.  fp32 x takes the FMA kernel ``wo_f32``.  The library sets
its kernels' shared memory and reads the card's residency once a device
and caches the tensor maps, so a call's host work is this wrapper's
checks and one launch.  It takes CUDA tensors only and raises on what the
kernels do not take (N not a multiple of 16).  Where x's rows are not
16-byte aligned for the kernel's loads (K not a multiple of 8, or for
int4 ``ceil(K/2)`` not one), x is copied into a zero-padded layout first;
the llama_7b widths need no copy.
"""

from __future__ import annotations

import ctypes

import torch

from ...kernels import build
from . import layer

__all__ = ["weight_only_matmul_cuda"]

PER_CHANNEL_GS = 1 << 30


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _x_layout(x2, K, half, int4):
    """``(x, ldx, xhi)``: x with 8-aligned rows and (int4) hi-plane start."""
    if not int4:
        if K % 8:
            x2 = torch.nn.functional.pad(x2, (0, _round8(K) - K))
        return x2.contiguous(), x2.shape[1], 0
    if K % 8 == 0 and half % 8 == 0:
        return x2.contiguous(), K, half
    h8 = _round8(half)
    xp = x2.new_zeros((x2.shape[0], 2 * h8))
    xp[:, :half] = x2[:, :half]
    xp[:, h8:h8 + K - half] = x2[:, half:]
    return xp, 2 * h8, h8


def weight_only_matmul_cuda(x, wq, scale, group_size: int, int4: bool,
                            tile: bool):
    """``[..., N]`` in x's dtype.  ``group_size`` -1 (per channel), 64 or
    128; ``tile``: fold the scale into the weight in x's dtype (the plain
    version's rule, ``ops.quant_linear.scale_mode``)."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("weight_only_matmul: the kernels need CUDA tensors")
    dt, dev = x.dtype, x.device
    code = layer.dtype_code(dt)
    K = x.shape[-1]
    R, N = wq.shape
    half = R if int4 else 0
    if R != (-(-K // 2) if int4 else K):
        raise ValueError(f"x has K {K}; codes of shape {tuple(wq.shape)} do "
                         f"not match ({'int4' if int4 else 'int8'})")
    if N % 16:
        raise ValueError(f"weight_only_matmul kernels take N a multiple of "
                         f"16, got {N}")
    layer.check_tensor(wq, "wq", (R, N), torch.int8, dev)
    if group_size == -1:
        gs, G = PER_CHANNEL_GS, 1
        want = (N,)
    else:
        gs, G = group_size, -(-K // group_size)
        want = (G, N)
    scale = layer.check_tensor(scale.to(torch.float32).contiguous(), "scale",
                               want, torch.float32, dev)
    lead = x.shape[:-1]
    xx, ldx, xhi = _x_layout(x.reshape(-1, K), K, half, int4)
    M = xx.shape[0]
    layer.check_tensor(xx, "x", (M, ldx), dt, dev)
    y = torch.empty((M, N), dtype=dt, device=dev)
    a = build.WoArgs(int4=int(int4), x_dtype=code, M=M, K=K, N=N, half=half,
                     ldx=ldx, xhi=xhi, gs=gs, G=G, tile_dq=int(tile),
                     x=xx.data_ptr(), w=wq.data_ptr(),
                     scale=scale.data_ptr(), y=y.data_ptr())
    build.check(build.library().pt_weight_only_matmul(
        ctypes.byref(a), layer.stream_handle()), "pt_weight_only_matmul")
    return y.reshape(*lead, N)
