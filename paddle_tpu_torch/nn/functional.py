"""Functional ops of the eager layers, with the JAX ops' dtype chains.

Counterpart of the parts of ``paddle_tpu/nn/functional`` that the eager
``LlamaForCausalLM`` / ``GPTForCausalLM`` reach: ``linear`` (weight
``[in, out]``), ``embedding``, the jnp-reference norms ``rms_norm`` and
``layer_norm`` (``norm.py:68-104``; the ``LayerNorm`` layer's, so GPT's
final norm), the fused norms over :mod:`..ops.norms`, ``relu``,
``tanh``, ``gelu``, ``dropout``, ``scaled_dot_product_attention``,
``cross_entropy`` and ``fused_linear_cross_entropy``
(``loss.py:117-144``) over :mod:`..ops.fused_cross_entropy`.

Operands of two float dtypes are promoted as jnp promotes them (bf16 with
fp32 gives fp32) where torch would raise: in ``linear`` and in attention,
as a bf16 ``MultiHeadAttention`` meets the fp32 cache of ``gen_cache``.

Randomness (dropout masks) comes from the ``generator`` argument, a
``torch.Generator`` on the tensor's device (its device's default generator
when None): the JAX package draws from its global key, so masks agree in
distribution, not in bits.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as _F

from ..ops import norms as _norms
from ..ops.flash_attention import flash_attention
from ..ops.fused_cross_entropy import linear_cross_entropy

__all__ = ["linear", "embedding", "rms_norm", "layer_norm",
           "fused_layer_norm", "fused_bias_dropout_residual_layer_norm",
           "relu", "tanh", "gelu", "dropout", "scaled_dot_product_attention",
           "cross_entropy", "fused_linear_cross_entropy"]


def _promoted(*ts):
    """``ts`` cast to their common dtype (a no-op when they share one)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight."""
    out = torch.matmul(*_promoted(x, weight))
    return out if bias is None else out + bias


def embedding(x, weight, padding_idx: Optional[int] = None):
    """Rows of ``weight`` at ids ``x``; rows at ``padding_idx`` read 0."""
    out = weight[x]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def rms_norm(x, weight=None, bias=None, epsilon: float = 1e-6,
             begin_norm_axis: int = -1):
    """The jnp reference: mean of squares in fp32 over the axes from
    ``begin_norm_axis`` on, ``x * rsqrt(. + eps)`` rounded to x's dtype,
    then times ``weight`` and plus ``bias`` with dtype promotion."""
    axis = begin_norm_axis if begin_norm_axis >= 0 else \
        x.ndim + begin_norm_axis
    axes = tuple(range(axis, x.ndim))
    xf = x.float()
    out = (xf * torch.rsqrt(xf.square().mean(axes, keepdim=True)
                            + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out if bias is None else out + bias


def rsqrt_rounded(v):
    """``rsqrt(v)`` in fp32, rounded once to v's dtype."""
    return torch.rsqrt(v.float()).to(v.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """The jnp reference: mean and variance over the trailing
    ``normalized_shape`` axes taken in fp32 and rounded to x's dtype, then
    ``(x - mean) * rsqrt(var + eps) * weight + bias`` with dtype
    promotion.  The rsqrt is taken in fp32 and rounded once, as XLA does
    (torch's bf16 rsqrt rounds the square root first)."""
    n = 1 if isinstance(normalized_shape, int) else len(normalized_shape)
    axes = tuple(range(x.ndim - n, x.ndim))
    xf = x.float()
    mean = xf.mean(axes, keepdim=True).to(x.dtype)
    var = xf.var(axes, unbiased=False, keepdim=True).to(x.dtype)
    out = (x - mean) * rsqrt_rounded(var + epsilon)
    if weight is not None:
        out = out * weight
    return out if bias is None else out + bias


def fused_layer_norm(x, weight, bias, epsilon: float = 1e-5):
    """LayerNorm over the last axis through the fused op (the kernel on
    CUDA, its plain version on the CPU)."""
    return _norms.layer_norm(x, weight, bias, epsilon)


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias, ln_weight, ln_bias, dropout_rate: float = 0.0,
        epsilon: float = 1e-5, training: bool = False,
        return_add_out: bool = False,
        generator: Optional[torch.Generator] = None):
    """``LayerNorm(residual + dropout(x + bias))`` through the fused op;
    with ``return_add_out`` also the pre-norm sum."""
    out, add = _norms.fused_bias_dropout_residual_layer_norm(
        x, residual, bias, ln_weight, ln_bias, dropout_rate, epsilon,
        training, generator)
    return (out, add) if return_add_out else out


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def gelu(x, approximate: bool = False):
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def _keep_mask(shape, p, generator, device):
    return torch.rand(shape, generator=generator, device=device) < 1.0 - p


def dropout(x, p: float = 0.5, training: bool = True,
            generator: Optional[torch.Generator] = None):
    """Zero each value with probability ``p`` and scale the kept ones by
    ``1 / (1 - p)`` (Paddle's ``upscale_in_train``)."""
    if not training or p == 0.0:
        return x
    keep = _keep_mask(x.shape, p, generator, x.device)
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def _sdpa_ref(q, k, v, mask=None, dropout_p: float = 0.0,
              causal: bool = False, generator=None, scale=None):
    """The JAX ``_sdpa_ref`` chain (``attention.py:22-47``), ``[B, S, H,
    D]``: logits in the input dtype, then fp32 with the causal mask
    (bottom-right aligned) and the boolean or additive mask, softmax in
    fp32, probabilities cast back to q's dtype (and dropped) before the
    value product; each product in its operands' promoted dtype, as jnp's
    einsum."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qt, kt = _promoted(qt, kt)
    logits = ((qt @ kt.transpose(-1, -2)) * s).float()
    low = torch.finfo(torch.float32).min
    if causal:
        ql, kl = logits.shape[-2:]
        cm = torch.ones((ql, kl), dtype=torch.bool,
                        device=q.device).tril(kl - ql)
        logits = torch.where(cm, logits, low)
    if mask is not None:
        logits = torch.where(mask, logits, low) if mask.dtype == torch.bool \
            else logits + mask.float()
    probs = torch.softmax(logits, -1).to(q.dtype)
    if dropout_p > 0.0:
        keep = _keep_mask(probs.shape, dropout_p, generator, q.device)
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0).to(q.dtype)
    return torch.matmul(*_promoted(probs, vt)).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 generator: Optional[torch.Generator] = None):
    """Attention in the ``[B, S, H, D]`` layout.  Without a mask and
    without dropout it takes the port's flash attention (the CUDA kernels
    on the card), as the JAX package takes ``tuned_flash`` on the TPU;
    otherwise the dense :func:`_sdpa_ref` chain (the JAX routing rule,
    ``attention.py:62-71``).  Flash takes one dtype: q, k and v of two are
    promoted to their common one first."""
    p = dropout_p if training else 0.0
    if attn_mask is None and p == 0.0:
        return flash_attention(*_promoted(query, key, value),
                               causal=is_causal)
    return _sdpa_ref(query, key, value, attn_mask, p, is_causal, generator)


def cross_entropy(input, label, ignore_index: int = -100):
    """Softmax cross-entropy over the last axis with hard labels, on the
    JAX package's dense chain (``log_softmax`` in the logits' dtype); the
    mean divides by the number of labels other than ``ignore_index``."""
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    lp = torch.log_softmax(input, -1)
    loss = torch.where(valid, -lp.gather(-1, safe[..., None])[..., 0], 0.0)
    return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)


def fused_linear_cross_entropy(input, weight, label, *, w_layout="vh",
                               ignore_index: int = -100):
    """Logits-free cross-entropy of ``softmax(input @ head)`` through
    :func:`..ops.fused_cross_entropy.linear_cross_entropy` (the linear-CE
    kernels on the card).  ``weight`` is ``[V, H]`` (``"vh"``, a tied
    embedding) or ``[H, V]`` (``"hv"``, a ``Linear``); the mean divides by
    the number of labels other than ``ignore_index``."""
    nll = linear_cross_entropy(input, weight, label, w_layout=w_layout,
                               ignore_index=ignore_index)
    valid = (label != ignore_index).to(nll.dtype)
    return nll.sum() / valid.sum().clamp_min(1.0)
