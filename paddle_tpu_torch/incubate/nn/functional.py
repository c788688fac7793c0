"""The incubate fused functional API, as far as the eager models reach it:
``fused_rms_norm`` and ``swiglu``.

Counterpart of ``paddle_tpu/incubate/nn/functional/__init__.py`` (:27-39
and :98-104), over :mod:`...ops.norms` and :mod:`...ops.fused` (the
kernels on the card, their plain versions on the CPU).  The other fused
entry points of that module (``fused_rotary_position_embedding``,
``fused_bias_act``, ``fused_dropout_add``, the fused attention and MMHA
calls) are ROADMAP queue 1 item 19.
"""

from __future__ import annotations

from ...ops import fused as _fused
from ...ops import norms as _norms

__all__ = ["fused_rms_norm", "swiglu"]


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon: float = 1e-6,
                   begin_norm_axis: int = -1, bias=None, residual=None):
    """``rms_norm(x + bias + residual) * w + norm_bias`` over the last axis
    (as the JAX op, whatever ``begin_norm_axis`` says).  With a
    ``residual`` returns ``(out, x + bias + residual)``."""
    if bias is not None:
        x = x + bias
    if residual is not None:
        x = x + residual
    out = _norms.rms_norm(x, norm_weight, epsilon)
    if norm_bias is not None:
        out = out + norm_bias
    return (out, x) if residual is not None else out


def swiglu(x, y=None):
    """``silu(x) * y``; with one argument, x's last axis splits into the
    two halves ``x[..., :h]`` and ``x[..., h:]``."""
    if y is None:
        h = x.shape[-1] // 2
        x, y = x[..., :h], x[..., h:]
    return _fused.swiglu(x, y)
