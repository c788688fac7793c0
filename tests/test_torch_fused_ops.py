"""The port's fused ops of kernels 17, 18 and 19 (``paddle_tpu_torch.ops.
fused``: ``fused_softmax_mask``, ``fused_bias_act``, ``fused_dropout_add``;
the incubate ``softmax_mask_fuse`` calls) against the JAX package's Pallas
kernels (``paddle_tpu.ops.pallas.fused``, interpret mode on the CPU).

The same numpy inputs go to both; the port gets copies.  Tolerances: fp32
1e-5, bf16 2e-2 (relative and absolute: one bf16 rounding of each output).

* softmax(x + mask): a ``[2, 1, 5, 7]`` mask broadcast over 3 heads and an
  odd row of 7, a row of 1; a row whose mask is all -inf gives NaN in both.
  The JAX calls are jitted, to keep the interpret-mode compiles few.
  The CUDA wrapper's mask layout (broadcast strides, dims merged) is
  pinned here too, as it is plain Python.
* act(x + bias) for every act of the JAX ``_ACTS``; ``"swiglu"`` with a
  bf16 x and an fp32 bias promotes to fp32 in both.
* dropout(x) + y with p 0 (training) and in eval: equal to JAX bit for bit
  (both are one fp32 add and one rounding).  Training cannot run in JAX on
  the CPU (no CPU rule for the TPU's ``prng_seed``), so it is held by its
  properties: kept values exactly ``x * scale``, the keep rate within 5
  sigma of 1 - p, the mask fixed by the seed and drawn from the generator,
  and the plain version's output equal bit for bit to a numpy Threefry
  reference of its bits, itself checked against ``jax.random``'s
  threefry2x32 and a Random123 known answer.  ``mode`` is dropped by the
  incubate call, as in JAX.
* ``jax.grad`` through the three JAX kernels fails; the port's backward
  raises ``NotImplementedError``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax._src import prng

import paddle_tpu as pt
from paddle_tpu.incubate.nn import functional as jIF
from paddle_tpu.ops.pallas import fused as jf
from paddle_tpu_torch import incubate as tinc
from paddle_tpu_torch.incubate.nn import functional as tIF
from paddle_tpu_torch.ops import fused as tf
from paddle_tpu_torch.ops import threefry
from paddle_tpu_torch.ops.cuda import fused as cf

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ["float32", "bfloat16"]
JDT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ACTS = ("gelu", "relu", "silu", "tanh", "sigmoid")


def _arrays(dt, seed, *shapes, scale=2.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            .astype(JDT[dt]) for s in shapes]


def _t(a, dt=None):
    t = torch.from_numpy(np.array(np.asarray(a).astype(np.float32),
                                  copy=True))
    return t if dt is None else t.to(TDT[dt])


def _close(got, want, dt):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dt])


# ------------------------------------------------------------ kernel 17
@pytest.mark.parametrize("dt", DTYPES)
def test_softmax_mask_matches_pallas(dt):
    """An odd row of 7 with a ``[2, 1, 5, 7]`` mask over 3 heads (one row
    fully masked: NaN in both) and a row of 1."""
    x7, x1 = _arrays(dt, 0, (2, 3, 5, 7), (4, 3, 1))
    m7, m1 = _arrays("float32", 1, (2, 1, 5, 7), (1,))
    m7 = np.where(m7 > 1.5, -np.inf, m7).astype(np.float32)
    m7[1, 0, 2] = -np.inf
    want = jax.jit(lambda *a: [jf.fused_softmax_mask(a[0], a[1]),
                               jf.fused_softmax_mask(a[2], a[3])])(
        x7, m7, x1, m1)
    for x, m, w in ((x7, m7, want[0]), (x1, m1, want[1])):
        got = tf.fused_softmax_mask(_t(x, dt), _t(m))
        assert got.dtype == TDT[dt] and got.shape == x.shape
        _close(got, w, dt)
        _close(tinc.softmax_mask_fuse(_t(x, dt), _t(m)), w, dt)
    got = tf.fused_softmax_mask(_t(x7, dt), _t(m7))
    assert torch.isnan(got[1, :, 2]).all() and not torch.isnan(got[0]).any()
    assert np.isnan(np.asarray(want[0], np.float32)[1, :, 2]).all()


@pytest.mark.parametrize("dt", DTYPES)
def test_softmax_upper_triangle_matches_jax(dt):
    x, = _arrays(dt, 2, (2, 3, 5, 6))
    want = pt.incubate.softmax_mask_fuse_upper_triangle(pt.to_tensor(x))
    got = tinc.softmax_mask_fuse_upper_triangle(_t(x, dt))
    assert got.dtype == TDT[dt]
    _close(got, np.asarray(want.astype("float32").numpy()), dt)


def test_cuda_wrapper_reads_the_mask_through_merged_strides():
    """The kernel's mask index: size-1 dims dropped, neighbours merged
    where the strides allow it; no layout needs more than 4 dims at x rank
    5, and a layout that would is refused."""
    m = torch.zeros(32, 1, 128, 128).expand(32, 12, 128, 128)
    assert cf._mask_layout(m.shape[:-1], m.stride()[:-1]) == [
        (32, 16384), (12, 0), (128, 128)]
    m = torch.zeros(1, 1, 5, 7).expand(2, 3, 5, 7)
    assert cf._mask_layout(m.shape[:-1], m.stride()[:-1]) == [(6, 0),
                                                              (5, 7)]
    assert cf._mask_layout((4, 3), (0, 0)) == [(12, 0)]
    assert cf._mask_layout((1, 1), (0, 0)) == []
    with pytest.raises(ValueError, match="takes 4"):
        cf._mask_layout((2, 2, 2, 2, 2), (0, 1, 0, 1, 0))


# ------------------------------------------------------------ kernel 18
@pytest.mark.parametrize("dt", DTYPES)
def test_bias_act_matches_pallas_for_every_act(dt):
    x, bias = _arrays(dt, 3, (3, 5, 40), (40,))
    want = jax.jit(lambda a, b: [jf.fused_bias_act(a, b, act)
                                 for act in ACTS])(x, bias)
    for act, w in zip(ACTS, want):
        got = tf.fused_bias_act(_t(x, dt), _t(bias, dt), act)
        assert got.dtype == TDT[dt], act
        _close(got, w, dt)
        _close(tf.bias_act_ref(_t(x, dt), _t(bias, dt), act), w, dt)


def test_swiglu_act_promotes_like_jax():
    x, = _arrays("bfloat16", 4, (3, 5, 40))
    bias, = _arrays("float32", 5, (40,))
    want = jIF.fused_bias_act(pt.to_tensor(x), pt.to_tensor(bias),
                              "swiglu").numpy()
    tx = _t(x, "bfloat16").requires_grad_()
    got = tIF.fused_bias_act(tx, _t(bias), "swiglu")
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert got.shape == (3, 5, 20)
    _close(got, want, "float32")
    got.sum().backward()               # kernel 16 has a VJP
    assert tx.grad.shape == tx.shape


def test_unknown_act_raises():
    with pytest.raises(ValueError, match="unknown act_method 'elu'"):
        tf.fused_bias_act(torch.zeros(2, 4), torch.zeros(4), "elu")


# ------------------------------------------------------------ kernel 19
@pytest.mark.parametrize("dt", DTYPES)
def test_dropout_add_without_drop_equals_pallas(dt):
    """p 0 in training, and p 0.3 in eval: both ``x + y``."""
    x, y = _arrays(dt, 6, (3, 5, 40), (3, 5, 40))
    want = jax.jit(lambda a, b: [jf.fused_dropout_add(a, b, 0.0, True),
                                 jf.fused_dropout_add(a, b, 0.3, False)])(
        x, y)
    for (p, training), w in zip(((0.0, True), (0.3, False)), want):
        got = tf.fused_dropout_add(_t(x, dt), _t(y, dt), p, training)
        assert got.dtype == TDT[dt]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(w).astype(np.float32))


def test_incubate_dropout_add_drops_mode_as_jax_does():
    x, y = _arrays("float32", 7, (4, 16), (4, 16))
    want = jIF.fused_dropout_add(pt.to_tensor(x), pt.to_tensor(y), p=0.5,
                                 training=False,
                                 mode="downscale_in_infer").numpy()
    got = tIF.fused_dropout_add(_t(x), _t(y), p=0.5, training=False,
                                mode="downscale_in_infer")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, x + y)     # not x * 0.5 + y


def _np_threefry(k0, k1, c0, c1):
    """Threefry-2x32-20 in numpy uint32 arithmetic (wrapping)."""
    ks = [np.uint32(k0), np.uint32(k1), np.uint32(k0 ^ k1 ^ 0x1BD11BDA)]
    x0, x1 = c0.astype(np.uint32) + ks[0], c1.astype(np.uint32) + ks[1]
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rot[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def test_threefry_is_jax_randoms_generator():
    """The numpy reference matches a Random123 known answer and
    ``jax.random``'s threefry2x32; the port's torch version matches it."""
    zero = np.zeros(1, np.uint32)
    assert [int(v[0]) for v in _np_threefry(0, 0, zero, zero)] == [
        0x6B200159, 0x99BA4EFE]
    c = np.arange(10, dtype=np.uint32)
    want = np.asarray(prng.threefry_2x32(jnp.array([7, 123], jnp.uint32),
                                         jnp.asarray(c)))
    got = np.concatenate(_np_threefry(7, 123, c[:5], c[5:]))
    np.testing.assert_array_equal(got, want)
    t0, t1 = threefry.threefry2x32(7, 123, torch.from_numpy(c[:5]).long(),
                                   torch.from_numpy(c[5:]).long())
    np.testing.assert_array_equal(np.concatenate([t0, t1]), want)


@pytest.mark.parametrize("dt", DTYPES)
def test_dropout_add_training_is_the_threefry_mask(dt):
    """Element i keeps x where word (i & 1) of Threefry at counter i >> 1,
    keyed (seed, 0), clears p in its top 24 bits; kept values are
    ``x * fp32(1 / (1 - p))``; all in fp32, one rounding.  The plain
    version equals a numpy replay of that rule bit for bit."""
    p, seed, shape = 0.25, 20241017, (64, 130)
    x, y = _arrays(dt, 8, shape, shape)
    got = tf.fused_dropout_add(_t(x, dt), _t(y, dt), p, True, seed=seed)
    n = x.size
    w0, w1 = _np_threefry(seed, 0, np.arange((n + 1) // 2),
                          np.zeros((n + 1) // 2))
    bits = np.stack([w0, w1], -1).reshape(-1)[:n]
    keep = ((bits >> 8).astype(np.float64) * 2.0 ** -24 >= np.float32(p))
    keep = keep.reshape(shape)
    scale = np.float32(1.0 / (1.0 - p))
    xf, yf = x.astype(np.float32), y.astype(np.float32)
    want = (np.where(keep, xf * scale, np.float32(0)) + yf).astype(JDT[dt])
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    rate, sd = keep.mean(), np.sqrt(p * (1 - p) / n)
    assert abs(rate - (1 - p)) < 5 * sd, rate


def test_dropout_add_seed_comes_from_the_generator():
    x = torch.ones(32, 64)
    y = torch.zeros(32, 64)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tIF.fused_dropout_add(x, y, p=0.5, training=True, generator=g)
    a, b, c = run(1), run(1), run(2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert set(torch.unique(a).tolist()) <= {0.0, 2.0}


# ------------------------------------------------------ no backward in JAX
def _jax_and_port_calls():
    bias8 = np.zeros(8, np.float32)
    return {
        "fused_softmax_mask": (
            lambda a: jf.fused_softmax_mask(a, jnp.zeros(8)).sum(),
            lambda t: tf.fused_softmax_mask(t, torch.zeros(8))),
        "fused_bias_act": (
            lambda a: jf.fused_bias_act(a, bias8, "relu").sum(),
            lambda t: tf.fused_bias_act(t, torch.zeros(8), "relu")),
        "fused_dropout_add": (
            lambda a: jf.fused_dropout_add(a, a, 0.0, False).sum(),
            lambda t: tf.fused_dropout_add(t, torch.ones(4, 8), 0.0, False)),
    }


@pytest.mark.parametrize("name", ["fused_softmax_mask", "fused_bias_act",
                                  "fused_dropout_add"])
def test_backward_raises_as_jax_grad_fails(name):
    jax_fn, port_fn = _jax_and_port_calls()[name]
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(jax_fn)(jnp.ones((4, 8)))
    t = torch.ones(4, 8, requires_grad=True)
    out = port_fn(t)
    with pytest.raises(NotImplementedError, match=f"{name} has no gradient"
                       r".*queue 3"):
        out.sum().backward()
