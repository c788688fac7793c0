"""The logits-free linear cross-entropy head: counterpart of
``paddle_tpu/ops/fused_cross_entropy.py`` (its dense tiers; the Pallas
kernels are ``paddle_tpu/ops/pallas/linear_ce.py``).

:func:`linear_cross_entropy` returns the per-token NLL of
``softmax(x @ head)`` without building the ``[T, V]`` logits: the forward
keeps only per-row running statistics over vocab chunks, and a
``torch.autograd.Function`` saves ``(x, w, labels, lse)`` and recomputes
the softmax chunk by chunk in the backward, giving grads for ``x`` and the
(possibly tied) head weight.

Each pass has two versions and no third:

* the plain PyTorch version (:func:`lce_fwd_ref`, :func:`lce_dz_ref`,
  :func:`lce_bwd_ref`) with the rounding points of the TPU kernels: fp32
  logits from the inputs, online max / sum-exp / label logit / smoothing
  sum per row; in the backward ``dz = g (exp(z - lse) - y)`` in fp32,
  rounded to w's dtype before ``dz @ w`` (dx) and to x's dtype before
  ``dz^T @ x`` (dw), fp32 accumulation, dx in x's dtype and dw in w's.  It
  runs for tensors on the CPU and sweeps the vocab in ``chunk`` columns.
* the hand-written CUDA kernels (:mod:`.cuda.linear_ce`) for tensors on a
  CUDA device, whose backward sweeps the vocab in slabs of ``chunk``
  columns: they launch or raise, with no fallback.  With fp32 x and a
  bf16 head they form the logits as two bf16 products on x's halves
  (:func:`lce_split_x_ref` is the plain version of the split), which
  keeps the fp32 logits of the TPU kernels' fp32 x bf16 dot, store dz as
  its own bf16 halves (:func:`lce_split_dz_ref`) and form dw as three
  bf16 products on the halves of dz and x (:func:`lce_dw_split_ref`),
  which keeps the TPU kernel's fp32 ``dz^T x``.

The JAX package's XLA tier keeps dz in fp32 for both products; where the
dtypes are bf16 the port rounds dz as the Pallas tier does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .cuda import linear_ce as _cuda

__all__ = ["NEG_INF", "linear_cross_entropy", "default_chunk",
           "naive_peak_bytes", "chunked_peak_bytes", "lce_fwd_ref",
           "lce_dz_ref", "lce_bwd_ref", "lce_split_x_ref",
           "lce_split_dz_ref", "lce_dw_split_ref"]

NEG_INF = -1e30


def default_chunk(vocab: int) -> int:
    """Vocab chunk width: the whole vocab when small, else 2048 (a
    ``[T, chunk]`` buffer per step: 32 MB of bf16 dz at T = 8192)."""
    return vocab if vocab <= 2048 else 2048


def naive_peak_bytes(tokens: int, vocab: int) -> int:
    """Activation bytes of the dense head: fp32 logits and the softmax
    residual its backward keeps."""
    return 2 * tokens * vocab * 4


def chunked_peak_bytes(tokens: int, vocab: int, chunk: Optional[int] = None
                       ) -> int:
    """Activation bytes of the chunked head: two live ``[T, chunk]`` fp32
    buffers plus the four ``[T]`` running statistics and the saved lse."""
    c = chunk or default_chunk(vocab)
    return 2 * tokens * c * 4 + 5 * tokens * 4


class _Meta(NamedTuple):
    chunk: int
    w_layout: str               # "vh" ([V, H]) or "hv" ([H, V])
    ignore_index: Optional[int]
    label_smoothing: float


def _cols(labels, c0, width):
    return labels[:, None] == torch.arange(c0, c0 + width,
                                           device=labels.device)[None, :]


def _halves(t):
    hi = t.to(torch.bfloat16)
    return torch.stack((hi, (t - hi.float()).to(torch.bfloat16)))


def lce_split_x_ref(x2):
    """fp32 x ``[T, H]`` as two bf16 halves ``[2, T, H]``: ``x_hi =
    bf16(x)`` and ``x_lo = bf16(x - x_hi)``, both rounded to nearest even
    (``x - x_hi`` is exact in fp32).  ``x_hi + x_lo`` holds x to 2^-17 of
    its value, and each product with a bf16 w is exact in fp32."""
    return _halves(x2)


def lce_split_dz_ref(dz):
    """fp32 dz ``[T, width]`` (:func:`lce_dz_ref`) as the split route
    stores it, two bf16 halves ``[2, T, width]``: ``dz_hi = bf16(dz)``
    (dz in w's dtype, dx's operand) and ``dz_lo = bf16(dz - dz_hi)``; the
    pair holds dz to 2^-17 of its value."""
    return _halves(dz)


def lce_dw_split_ref(dzs, xs):
    """The split route's ``dw_slab [width, H]`` bf16 (w's dtype there) from
    the halves ``dzs [2, T, width]`` (:func:`lce_split_dz_ref`) and ``xs
    [2, T, H]`` (:func:`lce_split_x_ref`): ``dz_hi^T x_hi + dz_hi^T x_lo +
    dz_lo^T x_hi`` as one fp32 product over bf16-valued operands (each
    term exact in fp32, the sum in fp32), rounded to bf16."""
    a = torch.cat((dzs[0], dzs[0], dzs[1])).float()       # [3T, width]
    b = torch.cat((xs[0], xs[1], xs[0])).float()          # [3T, H]
    return (a.t() @ b).bfloat16()


def lce_fwd_ref(x2, w, labels, *, chunk, ignore_index=None,
                label_smoothing=0.0):
    """Plain forward: ``(nll [T], lse [T])`` fp32 for x ``[T, H]``, w
    ``[V, H]``, labels ``[T]``; nll is 0 at ``ignore_index``."""
    T, V = x2.shape[0], w.shape[0]
    eps = float(label_smoothing)
    xf = x2.float()
    m = torch.full((T,), NEG_INF, dtype=torch.float32, device=x2.device)
    s, zl, sz = (torch.zeros(T, dtype=torch.float32, device=x2.device)
                 for _ in range(3))
    for c0 in range(0, V, chunk):
        z = xf @ w[c0:c0 + chunk].float().t()                  # [T, C] fp32
        m_new = torch.maximum(m, z.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(z - m_new[:, None]).sum(-1)
        m = m_new
        zl = zl + torch.where(_cols(labels, c0, z.shape[1]), z, 0.0).sum(-1)
        if eps > 0.0:
            sz = sz + z.sum(-1)
    lse = m + torch.log(s)
    nll = lse - (1.0 - eps) * zl - (eps / V) * sz if eps > 0.0 else lse - zl
    if ignore_index is not None:
        nll = torch.where(labels != ignore_index, nll, 0.0)
    return nll, lse


def lce_dz_ref(x2, w_slab, labels, lse, g, c0, vocab, label_smoothing=0.0):
    """Plain dz of the vocab slab ``w_slab = w[c0:c0 + width]``:
    ``g (exp(z - lse) - y)`` fp32 ``[T, width]``, y the one-hot label
    target (smoothed: ``(1 - eps) y + eps / vocab``)."""
    eps = float(label_smoothing)
    z = x2.float() @ w_slab.float().t()
    p = torch.exp(z - lse[:, None])
    y = _cols(labels, c0, z.shape[1]).float()
    if eps > 0.0:
        y = (1.0 - eps) * y + eps / vocab
    return g[:, None] * (p - y)


def lce_bwd_ref(x2, w, labels, lse, g, *, chunk, label_smoothing=0.0):
    """Plain backward: ``(dx [T, H] in x's dtype, dw [V, H] in w's dtype)``
    from the saved lse and the nll cotangent ``g`` (fp32, zero at ignored
    labels)."""
    V = w.shape[0]
    acc = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
    dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    xf = x2.float()
    for c0 in range(0, V, chunk):
        w_s = w[c0:c0 + chunk]
        dz = lce_dz_ref(xf, w_s, labels, lse, g, c0, V, label_smoothing)
        acc += dz.to(w.dtype).float() @ w_s.float()
        dw[c0:c0 + chunk] = (dz.to(x2.dtype).float().t() @ xf).to(w.dtype)
    return acc.to(x2.dtype), dw


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"linear_cross_entropy runs on CUDA or CPU tensors, "
                         f"got {t.device}")
    return t.device.type == "cuda"


def _vh(w, meta: _Meta):
    return w if meta.w_layout == "vh" else w.t()


class _LinearCE(torch.autograd.Function):
    """Differentiable in x and w; saves ``(x, w, labels, lse)`` as the JAX
    ``custom_vjp`` does, and recomputes the logits in the backward."""

    @staticmethod
    def forward(ctx, x, w, labels, meta):
        x2, lab = x.reshape(-1, x.shape[-1]), labels.reshape(-1)
        kw = dict(ignore_index=meta.ignore_index,
                  label_smoothing=meta.label_smoothing)
        if _on_cuda(x2):
            nll, lse = _cuda.linear_ce_fwd_cuda(x2, _vh(w, meta), lab, **kw)
        else:
            nll, lse = lce_fwd_ref(x2, _vh(w, meta), lab, chunk=meta.chunk,
                                   **kw)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.meta = meta
        return nll.reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        meta = ctx.meta
        x2, lab = x.reshape(-1, x.shape[-1]), labels.reshape(-1)
        g2 = g.reshape(-1).float()
        if meta.ignore_index is not None:
            g2 = torch.where(lab != meta.ignore_index, g2, 0.0)
        bwd = _cuda.linear_ce_bwd_cuda if _on_cuda(x2) else lce_bwd_ref
        dx, dw = bwd(x2, _vh(w, meta), lab, lse, g2, chunk=meta.chunk,
                     label_smoothing=meta.label_smoothing)
        return dx.reshape(x.shape), _vh(dw, meta), None, None


def linear_cross_entropy(x, w, labels, *, w_layout: str = "vh",
                         chunk: Optional[int] = None,
                         ignore_index: Optional[int] = None,
                         label_smoothing: float = 0.0,
                         axis_name: Optional[str] = None) -> torch.Tensor:
    """Per-token NLL of ``softmax(x @ head)`` without materializing logits.

    ``x``: ``[..., H]`` activations; ``w``: the (tied) head weight,
    ``[V, H]`` with ``w_layout="vh"`` (embedding layout) or ``[H, V]`` with
    ``"hv"`` (Linear layout); ``labels``: ``[...]`` int class ids.  Returns
    fp32 NLL shaped like ``labels``, 0 at ``ignore_index``; differentiable
    in ``x`` and ``w``.  x and w may differ in dtype (fp32 x with a bf16
    head is the GPT step's case).  ``chunk`` (default
    :func:`default_chunk`) is the vocab width of one step of the plain
    version's loop and of one slab of the CUDA backward.

    ``axis_name`` (the vocab-parallel tier for an mp-sharded head) is not
    ported and raises ``NotImplementedError``."""
    if w_layout not in ("vh", "hv"):
        raise ValueError(f"w_layout must be 'vh' or 'hv', got {w_layout!r}")
    if axis_name is not None:
        raise NotImplementedError(
            f"axis_name={axis_name!r} (the vocab-parallel linear-CE tier) is "
            f"not ported to paddle_tpu_torch yet (ROADMAP queue 1 item 17: "
            f"training runtime and distributed parallelism)")
    V, H = w.shape if w_layout == "vh" else w.shape[::-1]
    if x.shape[-1] != H:
        raise ValueError(f"x has hidden size {x.shape[-1]}, the head {H} "
                         f"(w {tuple(w.shape)}, layout {w_layout!r})")
    if x.shape[:-1] != labels.shape:
        raise ValueError(f"labels {tuple(labels.shape)} must match x's "
                         f"leading dims {tuple(x.shape[:-1])}")
    meta = _Meta(chunk=int(chunk or default_chunk(V)), w_layout=w_layout,
                 ignore_index=ignore_index,
                 label_smoothing=float(label_smoothing))
    return _LinearCE.apply(x, w, labels, meta)
