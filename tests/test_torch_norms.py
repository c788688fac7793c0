"""The port's fused row normalisations (``paddle_tpu_torch.ops.norms``)
against the JAX package's Pallas ones (``paddle_tpu.ops.pallas.norms``,
which run in interpret mode on the CPU by themselves).

Rows [3, 5, H 48]: 15 rows, not a power of two.  The same numpy inputs
go to both; the port gets copies.  Forward output, the saved row
statistics (``inv``, ``mean``) and every gradient (``torch.autograd``
against ``jax.vjp``, with random cotangents) agree within fp32 1e-5 and
bf16 2e-2 (relative and absolute: one bf16 rounding of each output).
The bias-residual LayerNorm's backward is the VJP of ``_ln_composed``,
which rounds ``x + bias + residual`` to x's dtype before the norm; its
statistics are held against the JAX LayerNorm kernel's on the fp32 sum.
With ``training`` and ``p > 0`` both packages take the composed chain
with a mask of their own generators, so that path is held to its
properties: the keep rate, the ``1 / (1 - p)`` scale, one mask for both
outputs, and the mask fixed by the generator's seed.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.norms import (
    _ln_fwd_impl, _rms_fwd_impl, fused_bias_dropout_residual_layer_norm,
    layer_norm, rms_norm)
from paddle_tpu_torch.ops import norms as tn

SHAPE, EPS = (3, 5, 48), 1e-5
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ["float32", "bfloat16"]
JDT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(dt, seed, *shapes, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale + shift).astype(np.float32)
            .astype(JDT[dt]) for s in shapes]


def _t(a, dt):
    return torch.from_numpy(np.array(a.astype(np.float32), copy=True)).to(
        TDT[dt])


def _close(got, want, dt):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(g, np.asarray(want).astype(np.float32),
                               **TOL[dt])


def _grads(fn, args, cot):
    ts = [a.clone().requires_grad_() for a in args]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, cot)
    return outs, [t.grad for t in ts]


@pytest.mark.parametrize("dt", DTYPES)
def test_rms_norm_matches_pallas(dt):
    H = SHAPE[-1]
    x, w, g = _arrays(dt, 0, SHAPE, (H,), SHAPE)
    w = (w.astype(np.float32) * 0.1 + 1).astype(JDT[dt])
    out, vjp = jax.vjp(lambda a, b: rms_norm(a, b, EPS), x, w)
    dx, dw = vjp(jnp.asarray(g))
    _, inv = _rms_fwd_impl(x, w, EPS)
    (t_out,), (t_dx, t_dw) = _grads(lambda a, b: tn.rms_norm(a, b, EPS),
                                    [_t(x, dt), _t(w, dt)], [_t(g, dt)])
    t_inv = tn.rms_norm_ref(_t(x, dt).reshape(-1, H), _t(w, dt), EPS)[1]
    assert t_out.dtype == TDT[dt] and t_dw.dtype == TDT[dt]
    for got, want in ((t_out, out), (t_inv, inv), (t_dx, dx), (t_dw, dw)):
        _close(got, want, dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_layer_norm_matches_pallas(dt):
    H = SHAPE[-1]
    x, w, b, g = _arrays(dt, 1, SHAPE, (H,), (H,), SHAPE, shift=0.5)
    out, vjp = jax.vjp(lambda a, c, d: layer_norm(a, c, d, EPS), x, w, b)
    grads = vjp(jnp.asarray(g))
    _, mean, inv = _ln_fwd_impl(x, w, b, EPS)
    (t_out,), t_grads = _grads(lambda a, c, d: tn.layer_norm(a, c, d, EPS),
                               [_t(x, dt), _t(w, dt), _t(b, dt)],
                               [_t(g, dt)])
    _, t_mean, t_inv = tn.layer_norm_ref(_t(x, dt).reshape(-1, H), _t(w, dt),
                                         _t(b, dt), EPS)
    for got, want in [(t_out, out), (t_mean, mean), (t_inv, inv)] + list(
            zip(t_grads, grads)):
        _close(got, want, dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_bias_residual_layer_norm_matches_pallas(dt):
    H = SHAPE[-1]
    x, res, bias, w, b, g_out, g_add = _arrays(
        dt, 2, SHAPE, SHAPE, (H,), (H,), (H,), SHAPE, SHAPE)
    outs, vjp = jax.vjp(
        lambda *a: fused_bias_dropout_residual_layer_norm(
            a[0], a[1], a[2], a[3], a[4], 0.0, EPS, False),
        x, res, bias, w, b)
    grads = vjp((jnp.asarray(g_out), jnp.asarray(g_add)))
    s32 = (x.astype(np.float32) + bias.astype(np.float32)) \
        + res.astype(np.float32)
    _, mean, inv = _ln_fwd_impl(s32, w.astype(np.float32),
                                b.astype(np.float32), EPS)
    t_outs, t_grads = _grads(
        lambda *a: tn.fused_bias_dropout_residual_layer_norm(
            a[0], a[1], a[2], a[3], a[4], 0.0, EPS, False),
        [_t(a, dt) for a in (x, res, bias, w, b)],
        [_t(g_out, dt), _t(g_add, dt)])
    _, _, t_mean, t_inv = tn.bias_residual_ln_ref(
        _t(x, dt).reshape(-1, H), _t(res, dt).reshape(-1, H), _t(bias, dt),
        _t(w, dt), _t(b, dt), EPS)
    for got, want in list(zip(t_outs, outs)) + [(t_mean, mean),
                                                 (t_inv, inv)] + list(
            zip(t_grads, grads)):
        _close(got, want, dt)


def test_dropout_path_properties():
    """Training with p > 0: the composed chain with one keep mask of rate
    ``1 - p``, kept values of ``x + bias`` scaled by ``1 / (1 - p)``, the
    residual added after, ``out`` the LayerNorm of that same ``add``, the
    mask fixed by the generator's seed, and gradients through it."""
    p, H = 0.3, 256
    x, res, bias = (torch.from_numpy(a) for a in _arrays(
        "float32", 3, (64, H), (64, H), (H,)))
    w, b = torch.ones(H), torch.zeros(H)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tn.fused_bias_dropout_residual_layer_norm(
            x, res, bias, w, b, p, EPS, True, gen)
    out, add = run(7)
    kept = (add - res).abs() > 0
    rate = float(kept.float().mean())
    assert abs(rate - (1 - p)) < 0.02, rate
    torch.testing.assert_close((add - res)[kept], ((x + bias) / (1 - p))[
        kept], rtol=1e-5, atol=1e-5)
    want, _, _ = tn.layer_norm_ref(add, w, b, EPS)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    out2, add2 = run(7)
    assert torch.equal(add, add2) and torch.equal(out, out2)
    assert not torch.equal(add, run(8)[1])
    xg = x.clone().requires_grad_()
    gen = torch.Generator().manual_seed(7)
    o, a = tn.fused_bias_dropout_residual_layer_norm(
        xg, res, bias, w, b, p, EPS, True, gen)
    (o.sum() + a.sum()).backward()
    assert torch.isfinite(xg.grad).all()
    assert torch.equal(xg.grad == 0, ~kept)        # dropped: no gradient


def test_eval_or_p_zero_takes_the_kernel_arithmetic():
    """``training=False`` with p > 0 and ``p = 0`` in training give the
    p = 0 op (the plain version of the kernel on the CPU)."""
    x, res, bias = (torch.from_numpy(a) for a in _arrays(
        "float32", 4, (6, 40), (6, 40), (40,)))
    w, b = torch.ones(40), torch.zeros(40)
    want = tn.bias_residual_ln_ref(x, res, bias, w, b, EPS)[:2]
    for p, training in ((0.5, False), (0.0, True)):
        got = tn.fused_bias_dropout_residual_layer_norm(
            x, res, bias, w, b, p, EPS, training)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
