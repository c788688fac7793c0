"""Fused row normalisations: ``rms_norm``, ``layer_norm`` and
``fused_bias_dropout_residual_layer_norm``.

Counterpart of ``paddle_tpu/ops/pallas/norms.py``.  Each normalises the
last axis of ``x [..., H]``; the gains and biases are ``[H]``.

Each forward has two versions and no third:

* the plain PyTorch version (:func:`rms_norm_ref`, :func:`layer_norm_ref`,
  :func:`bias_residual_ln_ref`) with the Pallas kernels' arithmetic, not
  the jnp references' (those are ``nn.functional.rms_norm`` /
  ``layer_norm``): x, the gains and biases (and the residual bias and the
  residual) upcast to fp32, the variance two-pass ``mean((x - mean)^2)``,
  ``inv = rsqrt(. + eps)``, the affine in fp32 and one rounding to x's
  dtype at the output.  Each also returns the fp32 row statistics ``[R]``
  the backward saves: ``inv`` (RMSNorm), ``mean`` and ``inv``.  It runs
  for tensors on the CPU.
* the hand-written CUDA kernels (:mod:`.cuda.norms`) for tensors on a
  CUDA device: they launch or raise, with no fallback.

The backwards are the JAX VJPs in torch ops: ``_rms_bwd``
(``norms.py:83-95``) and ``_ln_bwd`` (:155-168) from the saved statistics,
and for the bias-residual LayerNorm the VJP of ``_ln_composed``
(:200-209), which rounds ``x + bias + residual`` to x's dtype before the
norm while the forward normalises the fp32 sum (the JAX package's own
divergence, kept).  With ``training`` and ``p > 0`` the JAX package does
not run the kernel: it takes the composed chain with an explicit
Bernoulli keep mask on ``x + bias`` (``norms.py:246-256``), and so does
the port, drawing the mask from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cuda import norms as _cuda

__all__ = ["rms_norm", "layer_norm", "fused_bias_dropout_residual_layer_norm",
           "rms_norm_ref", "layer_norm_ref", "bias_residual_ln_ref",
           "rms_norm_bwd", "layer_norm_bwd", "ln_composed"]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"norms run on CUDA or CPU tensors, got {t.device}")
    return t.device.type == "cuda"


def _rows(t):
    return t.reshape(-1, t.shape[-1])


def _stats(xf, eps):
    """fp32 rows -> (mean, inv), each [R, 1]: two-pass variance."""
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    return mean, torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)


def rms_norm_ref(x2, w, eps: float):
    """Plain forward: ``(out [R, H] in x's dtype, inv [R] fp32)``."""
    xf = x2.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * inv * w.float()).to(x2.dtype), inv[:, 0]


def layer_norm_ref(x2, w, b, eps: float):
    """Plain forward: ``(out [R, H] in x's dtype, mean [R], inv [R])``."""
    xf = x2.float()
    mean, inv = _stats(xf, eps)
    out = (xf - mean) * inv * w.float() + b.float()
    return out.to(x2.dtype), mean[:, 0], inv[:, 0]


def bias_residual_ln_ref(x2, r2, bias, w, b, eps: float):
    """Plain forward of the p = 0 kernel: ``add = (x + bias) + residual`` in
    fp32, ``out = LayerNorm(add)``; returns ``(out, add in x's dtype,
    mean [R], inv [R])``."""
    s = (x2.float() + bias.float()) + r2.float()
    mean, inv = _stats(s, eps)
    out = (s - mean) * inv * w.float() + b.float()
    return out.to(x2.dtype), s.to(x2.dtype), mean[:, 0], inv[:, 0]


def rms_norm_bwd(x, w, inv, g):
    """JAX ``_rms_bwd``: ``(dx in x's dtype, dw in w's dtype)``."""
    x2, g2 = _rows(x).float(), _rows(g).float()
    inv = inv[:, None]
    xhat = x2 * inv
    wg = g2 * w.float()
    dx = inv * (wg - xhat * (wg * xhat).mean(-1, keepdim=True))
    dw = (g2 * xhat).sum(0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype)


def layer_norm_bwd(x, w, mean, inv, g):
    """JAX ``_ln_bwd``: ``(dx in x's dtype, dw, db in w's dtype)``."""
    x2, g2 = _rows(x).float(), _rows(g).float()
    xhat = (x2 - mean[:, None]) * inv[:, None]
    wg = g2 * w.float()
    dx = inv[:, None] * (wg - wg.mean(-1, keepdim=True)
                         - xhat * (wg * xhat).mean(-1, keepdim=True))
    return (dx.reshape(x.shape).to(x.dtype), (g2 * xhat).sum(0).to(w.dtype),
            g2.sum(0).to(w.dtype))


def ln_composed(x, bias, residual, w, lb, eps: float):
    """JAX ``_ln_composed``: ``add = x + bias + residual`` with the dtype
    promotion of each add, then LayerNorm of ``add`` in fp32; returns
    ``(out in x's dtype, add)``.  The bias-residual LayerNorm's VJP, and
    its whole forward under dropout."""
    add = x + bias + residual
    a32 = add.float()
    mean = a32.mean(-1, keepdim=True)
    var = ((a32 - mean) ** 2).mean(-1, keepdim=True)
    out = (a32 - mean) * torch.rsqrt(var + eps) * w.float() + lb.float()
    return out.to(x.dtype), add


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        x2 = _rows(x)
        fwd = _cuda.rms_norm_fwd_cuda if _on_cuda(x2) else rms_norm_ref
        out, inv = fwd(x2, w, eps)
        ctx.save_for_backward(x, w, inv)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        dx, dw = rms_norm_bwd(*ctx.saved_tensors, g)
        return dx, dw, None


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps):
        x2 = _rows(x)
        fwd = _cuda.layer_norm_fwd_cuda if _on_cuda(x2) else layer_norm_ref
        out, mean, inv = fwd(x2, w, b, eps)
        ctx.save_for_backward(x, w, mean, inv)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        dx, dw, db = layer_norm_bwd(*ctx.saved_tensors, g)
        return dx, dw, db, None


class _BiasResidualLN(torch.autograd.Function):
    """p = 0: the kernel forward, the VJP of :func:`ln_composed` backward
    (through torch autograd, as the JAX backward goes through
    ``jax.vjp``)."""

    @staticmethod
    def forward(ctx, x, bias, residual, w, lb, eps):
        x2 = _rows(x)
        fwd = _cuda.bias_residual_ln_fwd_cuda if _on_cuda(x2) \
            else bias_residual_ln_ref
        out, add, _, _ = fwd(x2, _rows(residual), bias, w, lb, eps)
        ctx.save_for_backward(x, bias, residual, w, lb)
        ctx.eps = eps
        return out.reshape(x.shape), add.reshape(x.shape)

    @staticmethod
    def backward(ctx, g_out, g_add):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ln_composed(*ins, ctx.eps)
            grads = torch.autograd.grad(outs, ins, (g_out, g_add))
        return (*grads, None)


def rms_norm(x, w, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + eps) * w`` in
    fp32, rounded to x's dtype; differentiable in x and w."""
    return _RMSNorm.apply(x, w, float(eps))


def layer_norm(x, w, b, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with the affine fused, fp32 inside,
    rounded to x's dtype; differentiable in x, w and b."""
    return _LayerNorm.apply(x, w, b, float(eps))


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias, ln_weight, ln_bias, dropout_rate: float = 0.0,
        epsilon: float = 1e-5, training: bool = False,
        generator: Optional[torch.Generator] = None):
    """``(LayerNorm(residual + dropout(x + bias)), residual + dropout(x +
    bias))``, the JAX op's ``(ln_out, add_out)``.

    p = 0 or eval: the kernel (the plain version on the CPU) with the
    composed VJP.  Training with p > 0: the composed chain, differentiable
    by torch autograd, with a keep mask drawn from ``generator`` (the
    default generator of x's device when None) with probability ``1 - p``
    and the kept values scaled by ``1 / (1 - p)``; one mask serves both
    outputs."""
    if training and dropout_rate > 0.0:
        keep = torch.rand(x.shape, generator=generator, device=x.device) \
            < 1.0 - dropout_rate
        xd = torch.where(keep, (x + bias) / (1.0 - dropout_rate),
                         0.0).to(x.dtype)
        return ln_composed(xd, torch.zeros_like(bias), residual, ln_weight,
                           ln_bias, epsilon)
    return _BiasResidualLN.apply(x, bias, residual, ln_weight, ln_bias,
                                 float(epsilon))
