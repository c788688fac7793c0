"""The eager path's row normalisations on the card: ``rms_norm_fwd``,
``layer_norm_fwd`` and ``bias_residual_ln_fwd`` (``kernels/csrc/
norms.cu``).

Each wrapper takes rows ``[R, H]`` on a CUDA device, checks them,
allocates the outputs and the fp32 row statistics and launches one kernel
on the current stream; it raises on what the kernels do not take (a dtype
other than float32 / bfloat16, no rows, a row longer than ``MAX_H``, a
residual of another dtype).  Rows are made contiguous; the ``[H]`` gains,
biases and the residual bias are passed as fp32 (upcasting a bf16 one is
exact, and the kernels compute in fp32).
"""

from __future__ import annotations

import ctypes

import torch

from ...kernels import build
from . import layer

__all__ = ["MAX_H", "rms_norm_fwd_cuda", "layer_norm_fwd_cuda",
           "bias_residual_ln_fwd_cuda"]

#: the longest row a block holds in registers (512 threads x 8 chunks of
#: 16 bytes)
MAX_H = {torch.float32: 16384, torch.bfloat16: 32768}


def _rows(x2, name="x"):
    if not isinstance(x2, torch.Tensor) or x2.device.type != "cuda":
        raise ValueError(f"norm kernels need CUDA tensors, {name} is on "
                         f"{getattr(x2, 'device', type(x2))}")
    layer.dtype_code(x2.dtype)
    if x2.ndim != 2 or x2.shape[0] == 0:
        raise ValueError(f"norm kernels take rows [R > 0, H], {name} is "
                         f"{tuple(x2.shape)}")
    if not 0 < x2.shape[1] <= MAX_H[x2.dtype]:
        raise ValueError(f"norm kernels take rows of 1..{MAX_H[x2.dtype]} "
                         f"{x2.dtype} values, got H {x2.shape[1]}")
    return x2.contiguous()


def _vec(t, name, H, dev):
    if not isinstance(t, torch.Tensor) or t.device != dev:
        raise ValueError(f"{name} must be a tensor on {dev}")
    if tuple(t.shape) != (H,):
        raise ValueError(f"{name} must be [{H}], got {tuple(t.shape)}")
    layer.dtype_code(t.dtype)
    return t.to(torch.float32).contiguous()


def _launch(fn_name, x2, eps, **ptrs):
    R, H = x2.shape
    stats = {n: torch.empty(R, dtype=torch.float32, device=x2.device)
             for n in ("mean", "inv")}
    out = torch.empty_like(x2)
    a = build.NormArgs(dtype=layer.dtype_code(x2.dtype), R=R, H=H,
                       eps=float(eps), x=x2.data_ptr(), out=out.data_ptr(),
                       mean=stats["mean"].data_ptr(),
                       inv=stats["inv"].data_ptr(),
                       **{n: t.data_ptr() for n, t in ptrs.items()})
    build.check(getattr(build.library(), fn_name)(ctypes.byref(a),
                                                  layer.stream_handle()),
                fn_name)
    return out, stats["mean"], stats["inv"]


def rms_norm_fwd_cuda(x2, w, eps: float):
    """``(out [R, H] in x's dtype, inv [R] fp32)``."""
    x2 = _rows(x2)
    wf = _vec(w, "w", x2.shape[1], x2.device)
    out, _, inv = _launch("pt_rms_norm_fwd", x2, eps, w=wf)
    return out, inv


def layer_norm_fwd_cuda(x2, w, b, eps: float):
    """``(out [R, H] in x's dtype, mean [R], inv [R] fp32)``."""
    x2 = _rows(x2)
    H, dev = x2.shape[1], x2.device
    wf, bf = _vec(w, "w", H, dev), _vec(b, "b", H, dev)
    return _launch("pt_layer_norm_fwd", x2, eps, w=wf, b=bf)


def bias_residual_ln_fwd_cuda(x2, r2, bias, w, b, eps: float):
    """``(out, add [R, H] in x's dtype, mean [R], inv [R] fp32)`` with
    ``add = (x + bias) + residual`` and ``out = LayerNorm(add)`` (of the
    fp32 sum)."""
    x2, r2 = _rows(x2), _rows(r2, "residual")
    if r2.shape != x2.shape or r2.dtype != x2.dtype:
        raise ValueError(f"residual {tuple(r2.shape)} {r2.dtype} must match "
                         f"x {tuple(x2.shape)} {x2.dtype}")
    H, dev = x2.shape[1], x2.device
    bias_f, wf, bf = (_vec(t, n, H, dev) for t, n in
                      ((bias, "bias"), (w, "ln_w"), (b, "ln_b")))
    add = torch.empty_like(x2)
    out, mean, inv = _launch("pt_bias_residual_ln_fwd", x2, eps, res=r2,
                             bias=bias_f, w=wf, b=bf, add=add)
    return out, add, mean, inv
