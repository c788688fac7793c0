"""The port's ``nn.functional`` plain ops against the JAX package's
``paddle_tpu.nn.functional`` on the same numpy inputs.

fp32 to 1e-5 (relative and absolute), bf16 to 2e-2: the jnp-reference
``layer_norm`` and ``rms_norm`` (the ``LayerNorm`` layer's and the
unfused RMSNorm's chains), ``gelu`` (tanh and erf), ``cross_entropy``
with ``ignore_index`` on 2-D logits (fp32 and bf16) and on 3-D logits
below the JAX package's chunked-NLL vocabulary,
``scaled_dot_product_attention`` without a mask (the port's flash
attention; the JAX package's dense chain on the CPU) and with a boolean
mask (both dense), and ``dropout``'s rate and scale.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch.nn import functional as tF

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arr(seed, shape, dt="float32", scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32).astype(
        JDT[dt])


def _t(a, dt="float32"):
    return torch.from_numpy(np.array(a.astype(np.float32), copy=True)).to(
        TDT[dt])


def _np(v):
    v = v.numpy() if hasattr(v, "numpy") else v
    return np.asarray(v).astype(np.float32)


def _close(got, want, dt="float32"):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               **TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_norms_match_jax(dt):
    x, w, b = _arr(0, (3, 5, 24), dt), _arr(1, (24,), dt), _arr(2, (24,), dt)
    want = jF.layer_norm(pt.to_tensor(x), 24, pt.to_tensor(w),
                         pt.to_tensor(b), 1e-5)
    _close(tF.layer_norm(_t(x, dt), 24, _t(w, dt), _t(b, dt), 1e-5), want,
           dt)
    want = jF.rms_norm(pt.to_tensor(x), pt.to_tensor(w), None, 1e-6)
    _close(tF.rms_norm(_t(x, dt), _t(w, dt), None, 1e-6), want, dt)


@pytest.mark.parametrize("approximate", [True, False])
def test_gelu_matches_jax(approximate):
    x = _arr(3, (4, 33), scale=3.0)
    _close(tF.gelu(_t(x), approximate=approximate),
           jF.gelu(pt.to_tensor(x), approximate=approximate))


@pytest.mark.parametrize("shape,dt", [((12, 50), "float32"),
                                      ((12, 50), "bfloat16"),
                                      ((2, 3, 50), "float32")],
                         ids=["2d", "2d bf16", "3d"])
def test_cross_entropy_matches_jax(shape, dt):
    logits = _arr(4, shape, dt, scale=2.0)
    labels = np.random.default_rng(5).integers(0, shape[-1], shape[:-1])
    labels.reshape(-1)[::5] = -100
    want = jF.cross_entropy(pt.to_tensor(logits), pt.to_tensor(labels))
    got = tF.cross_entropy(_t(logits, dt), torch.from_numpy(labels))
    _close(got, want, dt)


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_matches_jax(masked):
    q, k, v = (_arr(6 + i, (2, 10, 3, 16)) for i in range(3))
    mask = np.tril(np.ones((10, 10), bool), 2)[None, None] if masked \
        else None
    want = jF.scaled_dot_product_attention(
        pt.to_tensor(q), pt.to_tensor(k), pt.to_tensor(v),
        None if mask is None else pt.to_tensor(jnp.asarray(mask)),
        is_causal=not masked)
    got = tF.scaled_dot_product_attention(
        _t(q), _t(k), _t(v),
        None if mask is None else torch.from_numpy(mask),
        is_causal=not masked)
    _close(got, want)


def test_dropout_rate_and_scale():
    x = torch.ones(200, 100)
    gen = torch.Generator().manual_seed(0)
    y = tF.dropout(x, 0.25, generator=gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(tF.dropout(x, 0.25, training=False), x)
