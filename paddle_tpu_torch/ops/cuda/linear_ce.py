"""The linear-CE head's kernels on the card: ``linear_ce_fwd``,
``linear_ce_dz``, ``linear_ce_dx``, ``linear_ce_dw`` and
``linear_ce_split_x`` (``kernels/csrc/linear_ce.cu``).

Each wrapper checks its tensors, allocates its outputs and scratch and
launches on the current stream; it takes CUDA tensors only and raises on
anything the kernels do not take (a hidden size that is not a multiple of
8, no tokens, a dtype other than float32 / bfloat16).  ``x`` and ``w`` are
made contiguous (a no-op except for the transposed ``[H, V]`` Llama head)
and labels int32.  :func:`linear_ce_bwd_cuda` sweeps the vocab in slabs of
``chunk`` rows of ``w``, launching ``linear_ce_dz``, ``linear_ce_dx`` and
``linear_ce_dw`` once per slab.  With bf16 ``x`` and ``w`` the forward
writes per-tile row partials to a scratch it is given and folds them in a
fixed order, so two calls on the same inputs agree bit for bit; the kernel
library says how much scratch a call needs (``pt_linear_ce_scratch``,
from the kernel's own tile shape and routing).  With fp32 ``x`` and a
bf16 ``w`` (the GPT head) the forward and dz run as two bf16 products on
x's halves: each forward call and each backward call first launches
``linear_ce_split_x``, which writes ``xs = [bf16(x), bf16(x - bf16(x))]``
(:func:`~paddle_tpu_torch.ops.fused_cross_entropy.lce_split_x_ref` is its
plain version) into a scratch the backward's dz and dw launches share;
dz is stored as its own bf16 halves (``[2, T, ldz]``: ``bf16(dz)``, dx's
operand, and ``bf16(dz - bf16(dz))``), and dw is three bf16 products on
the halves of dz and x
(:func:`~paddle_tpu_torch.ops.fused_cross_entropy.lce_dw_split_ref`).
"""

from __future__ import annotations

import ctypes

import torch

from ...kernels import build
from . import layer

__all__ = ["linear_ce_fwd_cuda", "linear_ce_dz_cuda", "linear_ce_bwd_cuda",
           "linear_ce_split_x_cuda"]


_tickets = {}


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _row_tickets(dev, n):
    """int32 zeros ``[>= n]`` on ``dev`` for the current stream: the bf16
    forward's per-row-block tickets, which the kernel sets back to zero, so
    calls on one stream share them."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = _tickets[key] = torch.zeros(n, dtype=torch.int32, device=dev)
    return buf


def _args(x2, w, labels, label_smoothing=0.0, ignore_index=None):
    """Check the inputs every kernel reads; return ``(LceArgs, tensors)``
    with the checked tensors to keep alive."""
    if not isinstance(x2, torch.Tensor) or x2.device.type != "cuda":
        raise ValueError("linear-CE kernels need CUDA tensors")
    dev = x2.device
    if x2.ndim != 2 or w.ndim != 2 or w.shape[1] != x2.shape[1]:
        raise ValueError(f"linear-CE kernels take x [T, H] and w [V, H]; got "
                         f"{tuple(x2.shape)} and {tuple(w.shape)}")
    T, H = x2.shape
    V = w.shape[0]
    if T == 0 or V == 0:
        raise ValueError(f"linear-CE kernels need tokens and a vocabulary, "
                         f"got T={T}, V={V}")
    if H % 8:
        raise ValueError(f"linear-CE kernels take a hidden size that is a "
                         f"multiple of 8, got {H}")
    x2, w = x2.contiguous(), w.contiguous()
    layer.check_tensor(x2, "x", (T, H), x2.dtype, dev)
    layer.check_tensor(w, "w", (V, H), w.dtype, dev)
    labels = labels.to(device=dev, dtype=torch.int32).contiguous()
    layer.check_tensor(labels, "labels", (T,), torch.int32, dev)
    a = build.LceArgs(
        x_dtype=layer.dtype_code(x2.dtype), w_dtype=layer.dtype_code(w.dtype),
        T=T, H=H, V=V, has_ignore=int(ignore_index is not None),
        ignore_index=int(ignore_index or 0), eps=float(label_smoothing),
        x=x2.data_ptr(), w=w.data_ptr(), labels=labels.data_ptr())
    return a, [x2, w, labels]


def _launch(fn_name, a):
    build.check(getattr(build.library(), fn_name)(ctypes.byref(a),
                                                  layer.stream_handle()),
                fn_name)


def _scratch(a):
    """The library's scratch sizes for ``a``: fp32 words of the forward's
    ``part``, its int32 tickets, and bf16 elements of ``xs`` (0 each where
    the call's route takes none)."""
    sizes = (ctypes.c_longlong * 3)()
    build.check(build.library().pt_linear_ce_scratch(ctypes.byref(a), sizes),
                "pt_linear_ce_scratch")
    return sizes


def _split_x(a, n, dev, keep):
    """On the split route (``n``, xs's size, > 0): ``linear_ce_split_x``
    into a new ``xs`` on ``dev``, which ``a`` points at and ``keep``
    holds."""
    if n:
        xs = torch.empty(n, dtype=torch.bfloat16, device=dev)
        a.xs = xs.data_ptr()
        keep.append(xs)
        _launch("pt_linear_ce_split_x", a)


def linear_ce_split_x_cuda(x2):
    """``xs [2, T, H]`` bf16 from ``linear_ce_split_x``: ``xs[0] =
    bf16(x)``, ``xs[1] = bf16(x - xs[0])``, for fp32 x ``[T, H]``."""
    if not isinstance(x2, torch.Tensor) or x2.device.type != "cuda":
        raise ValueError("linear_ce_split_x needs a CUDA tensor")
    if x2.ndim != 2 or x2.shape[0] == 0 or x2.shape[1] % 8:
        raise ValueError(f"linear_ce_split_x takes x [T, H] with T > 0 and "
                         f"H a multiple of 8, got {tuple(x2.shape)}")
    x2 = x2.contiguous()
    T, H = x2.shape
    layer.check_tensor(x2, "x", (T, H), torch.float32, x2.device)
    a = build.LceArgs(x_dtype=build.PT_F32, w_dtype=build.PT_BF16, T=T, H=H,
                      x=x2.data_ptr())
    keep = []
    _split_x(a, 2 * T * H, x2.device, keep)
    return keep[0].view(2, T, H)


def linear_ce_fwd_cuda(x2, w, labels, *, ignore_index=None,
                       label_smoothing=0.0):
    """``(nll [T], lse [T])`` fp32 from ``linear_ce_fwd``; x ``[T, H]``,
    w ``[V, H]``."""
    a, keep = _args(x2, w, labels, label_smoothing, ignore_index)
    dev = x2.device
    nll = torch.empty(a.T, dtype=torch.float32, device=dev)
    lse = torch.empty(a.T, dtype=torch.float32, device=dev)
    a.nll, a.lse = nll.data_ptr(), lse.data_ptr()
    sizes = _scratch(a)
    if sizes[0]:
        part = torch.empty(sizes[0], dtype=torch.float32, device=dev)
        tickets = _row_tickets(dev, sizes[1])
        a.part, a.tickets = part.data_ptr(), tickets.data_ptr()
        keep += [part, tickets]
    _split_x(a, sizes[2], dev, keep)
    _launch("pt_linear_ce_fwd", a)
    del keep
    return nll, lse


def _bwd_args(x2, w, labels, lse, g, label_smoothing, width):
    """The backward's ``LceArgs``, its tensors, and dz scratch for slabs up
    to ``width`` rows: ``[T, round8(width)]`` in w's dtype, and in x's where
    the two differ; on the split route (the library's ``xs`` size > 0)
    instead one bf16 ``[2, T, round8(width)]``, dz's high half (dz in w's
    dtype) and its low half, and x's halves (one ``linear_ce_split_x``
    launch), which every dz and dw launch of the call reads."""
    a, keep = _args(x2, w, labels, label_smoothing)
    x2, w = keep[0], keep[1]
    lse = lse.to(device=x2.device, dtype=torch.float32).contiguous()
    g = g.to(device=x2.device, dtype=torch.float32).contiguous()
    layer.check_tensor(lse, "lse", (a.T,), torch.float32, x2.device)
    layer.check_tensor(g, "g", (a.T,), torch.float32, x2.device)
    n_xs = _scratch(a)[2]
    shape = (a.T, _round8(width))
    if n_xs:
        dz_x = torch.empty((2, *shape), dtype=torch.bfloat16, device=w.device)
        dz_w = dz_x[0]
        a.dz_w, a.dz_x = dz_w.data_ptr(), dz_x[1].data_ptr()
    else:
        dz_w = torch.empty(shape, dtype=w.dtype, device=w.device)
        dz_x = dz_w if x2.dtype == w.dtype else torch.empty(
            shape, dtype=x2.dtype, device=w.device)
        a.dz_w, a.dz_x = dz_w.data_ptr(), dz_x.data_ptr()
    a.lse, a.g = lse.data_ptr(), g.data_ptr()
    keep += [lse, g]
    _split_x(a, n_xs, x2.device, keep)
    return a, keep + [dz_w, dz_x]


def _slab(a, c0, width):
    a.c0, a.width, a.ldz = c0, width, _round8(width)


def linear_ce_dz_cuda(x2, w, labels, lse, g, c0, width, *,
                      label_smoothing=0.0):
    """dz of the vocab slab ``[c0, c0 + width)`` from ``linear_ce_dz``:
    ``(dz in w's dtype, dz in x's dtype)``, each ``[T, width]`` (one tensor
    twice when the dtypes agree); with fp32 x and bf16 w ``(dz_hi, dzs)``,
    ``dzs [2, T, width]`` bf16 the halves ``(dz_hi, dz_lo)`` whose sum holds
    dz (``dzs[0]`` is ``dz_hi``)."""
    a, keep = _bwd_args(x2, w, labels, lse, g, label_smoothing, width)
    _slab(a, int(c0), int(width))
    _launch("pt_linear_ce_dz", a)
    dz_w, dz_x = keep[-2], keep[-1]           # [.., T, ldz], ldz = round8(width)
    return dz_w[:, :width], dz_x[..., :width]


def linear_ce_bwd_cuda(x2, w, labels, lse, g, *, chunk, label_smoothing=0.0):
    """``(dx [T, H] in x's dtype, dw [V, H] in w's dtype)``: per slab of
    ``chunk`` vocab rows, ``linear_ce_dz`` then ``linear_ce_dx`` (into an
    fp32 accumulator; the last slab writes dx) then ``linear_ce_dw``.  ``g``
    is the nll cotangent, already zero at ignored labels."""
    V = w.shape[0]
    C = max(1, min(int(chunk), V))
    a, keep = _bwd_args(x2, w, labels, lse, g, label_smoothing, C)
    dev, T, H = x2.device, a.T, a.H
    dx = torch.empty((T, H), dtype=x2.dtype, device=dev)
    acc = dx if x2.dtype == torch.float32 else torch.empty(
        (T, H), dtype=torch.float32, device=dev)
    dw = torch.empty((V, H), dtype=w.dtype, device=dev)
    a.dx_acc, a.dx, a.dw = acc.data_ptr(), dx.data_ptr(), dw.data_ptr()
    for c0 in range(0, V, C):
        _slab(a, c0, min(C, V - c0))
        a.first, a.last = int(c0 == 0), int(c0 + C >= V)
        for fn_name in ("pt_linear_ce_dz", "pt_linear_ce_dx",
                        "pt_linear_ce_dw"):
            _launch(fn_name, a)
    del keep
    return dx, dw
