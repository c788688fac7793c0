"""The port's fused RoPE (``paddle_tpu_torch.ops.rope`` and the incubate
``fused_rotary_position_embedding``) against the JAX package's Pallas one
(``paddle_tpu.ops.pallas.rope``, interpret mode on the CPU).

q, k ``[2, 8, 3, 16]`` (3 heads: an odd head count), one case at head_dim
6 (an odd half, the kernel's scalar path), the same numpy inputs to both.
The forward and the gradients (``torch.autograd`` against ``jax.vjp``,
random cotangents) agree within fp32 1e-5 and bf16 2e-2; so do the
caller's cos / sin (bf16, Paddle's ``[1, S, 1, D]``), ``position_ids``,
q alone, and the tables of ``rope_cos_sin``.  v passes through untouched
and ``use_neox_rotary_style`` is ignored, as in JAX.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.rope import fused_rope as j_rope
from paddle_tpu.ops.pallas.rope import rope_cos_sin as j_tables
from paddle_tpu_torch.incubate.nn import functional as tIF
from paddle_tpu_torch.ops import rope as tr

SHAPE = (2, 8, 3, 16)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(dt, seed, n, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32).astype(JDT[dt])
            for _ in range(n)]


def _t(a, dt):
    return torch.from_numpy(np.array(np.asarray(a).astype(np.float32),
                                     copy=True)).to(TDT[dt])


def _close(got, want, dt):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dt])


@jax.jit
def _jax_rope_vjp(q, k, gq, gk):
    """JAX's outputs and VJP, jitted: run op by op, the interpret-mode
    kernel and its VJP take ~10 s on the CPU, compiled ~1 s."""
    (oq, ok), vjp = jax.vjp(lambda a, b: j_rope(a, b)[:2], q, k)
    return (oq, ok, *vjp((gq, gk)))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [SHAPE, (1, 5, 2, 6)],
                         ids=["D16", "D6"])
def test_forward_and_grads_match_pallas(dt, shape):
    q, k, gq, gk = _arrays(dt, 0, 4, shape)
    oq, ok, dq, dk = _jax_rope_vjp(q, k, gq, gk)
    tq, tk = (_t(a, dt).requires_grad_() for a in (q, k))
    t_oq, t_ok, t_v = tr.fused_rope(tq, tk)
    torch.autograd.backward((t_oq, t_ok), (_t(gq, dt), _t(gk, dt)))
    assert t_v is None and t_oq.dtype == TDT[dt] and tq.grad.dtype == TDT[dt]
    for got, want in ((t_oq, oq), (t_ok, ok), (tq.grad, dq), (tk.grad, dk)):
        _close(got, want, dt)


def test_grad_is_the_inverse_rotation():
    """The VJP rotates the cotangent back: the grad of ``<rope(q), g>``
    is ``rope_ref(g, sign=-1)``, and rotating forward then back is the
    identity."""
    (q,) = _arrays("float32", 1, 1)
    cos, sin = tr.rope_cos_sin(SHAPE[1], SHAPE[-1])
    tq = _t(q, "float32").requires_grad_()
    g = torch.linspace(-1, 1, tq.numel()).reshape(SHAPE)
    (tr.fused_rope(tq)[0] * g).sum().backward()
    torch.testing.assert_close(tq.grad, tr.rope_ref(g, cos, sin, -1.0))
    torch.testing.assert_close(
        tr.rope_ref(tr.rope_ref(tq.detach(), cos, sin), cos, sin, -1.0),
        tq.detach(), rtol=1e-5, atol=1e-5)


def test_caller_tables_position_ids_and_q_alone_match_jax():
    q, k, v = _arrays("float32", 2, 3)
    S, D = SHAPE[1], SHAPE[-1]
    pos = np.array([3, 1, 4, 1, 5, 9, 2, 6])
    want_q, want_k, _ = j_rope(q, k, position_ids=jnp.asarray(pos))
    got_q, got_k, got_v = tIF.fused_rotary_position_embedding(
        _t(q, "float32"), _t(k, "float32"), _t(v, "float32"),
        position_ids=torch.from_numpy(pos))
    _close(got_q, want_q, "float32")
    _close(got_k, want_k, "float32")
    _close(got_v, v, "float32")
    # the caller's tables, bf16 in Paddle's [1, S, 1, D] layout
    jc, js = j_tables(S, D, dtype=jnp.bfloat16)
    want_q, _, _ = j_rope(q, sin=js.reshape(1, S, 1, D),
                          cos=jc.reshape(1, S, 1, D))
    tc, ts = tr.rope_cos_sin(S, D, dtype=torch.bfloat16)
    got_q, got_k, got_v = tr.fused_rope(_t(q, "float32"),
                                        sin=ts.reshape(1, S, 1, D),
                                        cos=tc.reshape(1, S, 1, D))
    assert got_k is None and got_v is None
    _close(got_q, want_q, "float32")
    for got, want in zip((tc, ts), (jc, js)):
        _close(got, want, "bfloat16")


def test_v_passes_through_and_the_neox_flag_is_ignored():
    q, k, v = (_t(a, "float32") for a in _arrays("float32", 3, 3))
    a = tr.fused_rope(q, k, v, use_neox_rotary_style=True)
    b = tr.fused_rope(q, k, v, use_neox_rotary_style=False)
    assert a[2] is v and b[2] is v
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)


def test_tables_match_jax_and_position_ids_are_checked():
    for S, D in ((8, 16), (5, 6)):
        jc, js = j_tables(S, D)
        tc, ts = tr.rope_cos_sin(S, D)
        _close(tc, jc, "float32")
        _close(ts, js, "float32")
    with pytest.raises(ValueError, match="position_ids"):
        tr.rope_cos_sin(8, 16, position_ids=torch.arange(7))
    with pytest.raises(ValueError, match=r"\[B, S, H, D\]"):
        tr.fused_rope(torch.zeros(8, 3, 16))
