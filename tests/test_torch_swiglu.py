"""The port's SwiGLU (``paddle_tpu_torch.ops.fused.swiglu`` and the
incubate ``swiglu``) against the JAX package's Pallas one
(``paddle_tpu.ops.pallas.fused.swiglu``, interpret mode on the CPU).

Rows [3, 7, 40] (21 rows), the same numpy inputs to both: the forward
and both gradients (``torch.autograd`` against ``jax.vjp``) within fp32
1e-5 and bf16 2e-2 (one bf16 rounding of each output), and the
one-argument form, which splits the last axis into halves, against the
JAX incubate op.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.nn import functional as jIF
from paddle_tpu.ops.pallas.fused import swiglu as j_swiglu
from paddle_tpu_torch.incubate.nn import functional as tIF
from paddle_tpu_torch.ops import fused as tf

SHAPE = (3, 7, 40)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(dt, seed, n, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 2).astype(np.float32).astype(
        JDT[dt]) for _ in range(n)]


def _t(a, dt):
    return torch.from_numpy(np.array(a.astype(np.float32), copy=True)).to(
        TDT[dt])


def _close(got, want, dt):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_swiglu_matches_pallas(dt):
    x, y, g = _arrays(dt, 0, 3)
    out, vjp = jax.vjp(j_swiglu, x, y)
    dx, dy = vjp(jnp.asarray(g))
    tx, ty = (_t(a, dt).requires_grad_() for a in (x, y))
    t_out = tf.swiglu(tx, ty)
    t_out.backward(_t(g, dt))
    assert t_out.dtype == TDT[dt] and tx.grad.dtype == TDT[dt]
    for got, want in ((t_out, out), (tx.grad, dx), (ty.grad, dy)):
        _close(got, want, dt)
    _close(tf.swiglu_ref(_t(x, dt), _t(y, dt)), out, dt)


def test_one_argument_split_matches_jax():
    (xy,) = _arrays("float32", 1, 1, shape=(3, 7, 80))
    want = jIF.swiglu(pt.to_tensor(xy)).numpy()
    txy = _t(xy, "float32").requires_grad_()
    got = tIF.swiglu(txy)
    _close(got, want, "float32")
    torch.testing.assert_close(got, tf.swiglu(txy[..., :40], txy[..., 40:]))
    got.sum().backward()
    assert txy.grad.shape == txy.shape and torch.isfinite(txy.grad).all()


def test_swiglu_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="one shape"):
        tf.swiglu(torch.zeros(2, 4), torch.zeros(2, 5))
