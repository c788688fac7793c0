"""The fused elementwise and row kernels on the card: ``swiglu_fwd``
(``kernels/csrc/swiglu.cu``), ``softmax_mask_fwd``, ``bias_act_fwd`` and
``dropout_add_fwd`` (``kernels/csrc/fused_ops.cu``).

Each wrapper takes CUDA tensors (float32 or bfloat16), makes the rows
contiguous (a no-op for the layers' tensors), allocates the output and
launches one kernel on the current stream; it raises on anything else.
The softmax mask is read in place through broadcast strides (no copy of a
``[B, H, S, S]`` mask); the activation bias is passed as fp32 (upcasting
a bf16 one is exact, and the kernel computes in fp32); the dropout seed
is a one-element int64 tensor on the card, read by the kernel, so drawing
it costs no host sync.
"""

from __future__ import annotations

import ctypes

import torch

from ...kernels import build
from . import layer

__all__ = ["ACTS", "swiglu_fwd_cuda", "softmax_mask_fwd_cuda",
           "bias_act_fwd_cuda", "dropout_scale", "dropout_add_fwd_cuda"]

#: the activations of ``bias_act_fwd``, by their codes in ``fused_ops.cu``
ACTS = {"gelu": 0, "relu": 1, "silu": 2, "tanh": 3, "sigmoid": 4}


def _same_as_x(y, x, what):
    if not isinstance(y, torch.Tensor) or y.device != x.device or \
            y.shape != x.shape or y.dtype != x.dtype:
        raise ValueError(f"{what}: y must match x ({tuple(x.shape)}, "
                         f"{x.dtype}, {x.device})")


def _cuda_tensor(t, what):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: the kernel needs CUDA tensors")
    code = layer.dtype_code(t.dtype)
    if t.numel() == 0:
        raise ValueError(f"{what}: the kernel needs at least one element")
    return code


def swiglu_fwd_cuda(x, y):
    """``silu(x) * y`` in x's shape and dtype."""
    code = _cuda_tensor(x, "swiglu")
    _same_as_x(y, x, "swiglu")
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty_like(x)
    build.check(build.library().pt_swiglu_fwd(
        code, x.numel(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
        layer.stream_handle()), "pt_swiglu_fwd")
    return out


def _mask_layout(shape, strides):
    """Leading sizes and mask strides with size-1 dims dropped and
    neighbours merged where the strides allow it (at most 4 remain)."""
    dims = [(n, st) for n, st in zip(shape, strides) if n != 1]
    out = []
    for n, st in dims:
        if out and out[-1][1] == st * n:
            out[-1] = (out[-1][0] * n, st)
        else:
            out.append((n, st))
    if len(out) > 4:
        raise ValueError(f"softmax_mask: the mask's broadcast over "
                         f"{tuple(shape)} needs {len(out)} index dims, the "
                         f"kernel takes 4")
    return out


def softmax_mask_fwd_cuda(x, mask):
    """``softmax(x + mask)`` over the last axis, in x's shape and dtype;
    ``mask`` broadcastable to x (float32 or bfloat16; other dtypes are
    cast to float32, as the Pallas kernel upcasts)."""
    code = _cuda_tensor(x, "softmax_mask")
    if not isinstance(mask, torch.Tensor) or mask.device != x.device:
        raise ValueError(f"softmax_mask: mask must be a tensor on {x.device}")
    if mask.dtype not in (torch.float32, torch.bfloat16):
        mask = mask.to(torch.float32)
    try:
        m = torch.broadcast_to(mask, x.shape)
    except RuntimeError as e:
        raise ValueError(f"softmax_mask: mask {tuple(mask.shape)} does not "
                         f"broadcast to x {tuple(x.shape)}") from e
    S = x.shape[-1]
    if S > 1 and m.stride(-1) not in (0, 1):
        m = torch.broadcast_to(mask.contiguous(), x.shape)
    if x.numel() // S >= 2 ** 31:
        raise ValueError(f"softmax_mask: the kernel takes fewer than 2^31 "
                         f"rows, got {x.numel() // S}")
    lead = _mask_layout(x.shape[:-1], m.stride()[:-1])
    x = x.contiguous()
    out = torch.empty_like(x)
    a = build.SoftmaxArgs(
        dtype=code, mask_dtype=layer.dtype_code(m.dtype), S=S,
        nd=len(lead), R=x.numel() // S,
        size=(ctypes.c_longlong * 4)(*[n for n, _ in lead]),
        mstride=(ctypes.c_longlong * 4)(*[st for _, st in lead]),
        mcol=m.stride(-1) if S > 1 else 0, x=x.data_ptr(),
        mask=m.data_ptr(), out=out.data_ptr())
    build.check(build.library().pt_softmax_mask_fwd(ctypes.byref(a),
                                                    layer.stream_handle()),
                "pt_softmax_mask_fwd")
    return out


def bias_act_fwd_cuda(x, bias, act: str = "gelu"):
    """``act(x + bias)`` in fp32, in x's shape and dtype; ``bias [H]``
    over x's last axis; ``act`` one of :data:`ACTS`."""
    code = _cuda_tensor(x, "bias_act")
    if act not in ACTS:
        raise ValueError(f"bias_act: unknown activation {act!r} (the kernel "
                         f"takes {', '.join(ACTS)})")
    H = x.shape[-1]
    if not isinstance(bias, torch.Tensor) or bias.device != x.device or \
            tuple(bias.shape) != (H,):
        raise ValueError(f"bias_act: bias must be a [{H}] tensor on "
                         f"{x.device}")
    layer.dtype_code(bias.dtype)
    x, bias = x.contiguous(), bias.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    build.check(build.library().pt_bias_act_fwd(
        code, ACTS[act], x.numel() // H, H, x.data_ptr(), bias.data_ptr(),
        out.data_ptr(), layer.stream_handle()), "pt_bias_act_fwd")
    return out


def dropout_scale(p: float) -> float:
    """``1 / (1 - p)`` rounded once to fp32 (what the kernel multiplies the
    kept values by); inf at p >= 1, where nothing is kept."""
    return float(torch.tensor(1.0 / (1.0 - p) if p < 1.0 else float("inf"),
                              dtype=torch.float32))


def dropout_add_fwd_cuda(x, y, p: float, drop: bool, seed=None):
    """``dropout(x) + y`` in fp32, in x's shape and dtype.  ``drop`` False:
    ``x + y``.  Else x is kept by the Threefry mask of ``seed`` (a
    one-element int64 tensor on x's device) at rate ``p``, kept values
    times :func:`dropout_scale`."""
    code = _cuda_tensor(x, "dropout_add")
    _same_as_x(y, x, "dropout_add")
    if drop and (not isinstance(seed, torch.Tensor) or seed.numel() != 1 or
                 seed.dtype != torch.int64 or seed.device != x.device):
        raise ValueError(f"dropout_add: the seed must be a one-element int64 "
                         f"tensor on {x.device}")
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty_like(x)
    build.check(build.library().pt_dropout_add_fwd(
        code, x.numel(), int(bool(drop)), float(p), dropout_scale(p),
        seed.data_ptr() if drop else None, x.data_ptr(), y.data_ptr(),
        out.data_ptr(), layer.stream_handle()), "pt_dropout_add_fwd")
    return out
