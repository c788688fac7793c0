"""The port's logits-free linear cross-entropy head against the JAX
package's.

* the port's plain version against the JAX XLA tier (``backend="xla"``)
  at fp32, loss and both grads under a non-trivial cotangent, 1e-5: both
  weight layouts, ``ignore_index``, label smoothing with an uneven last
  chunk;
* against the JAX Pallas kernels run in interpret mode (``pallas_call``
  at ``ops/pallas/linear_ce.py:152/253/270``), whose rounding points the
  plain version follows, in two small cases: fp32 with ``ignore_index``
  and V not a multiple of the chunk (1e-5); fp32 x with a bf16 head (the
  GPT step's case), then all bf16 (2e-2: one bf16 rounding of dz and of
  each grad);
* the chunk width moves only the fp32 summation order; the vocab-parallel
  tier and a bad layout raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.fused_cross_entropy import \
    linear_cross_entropy as j_lce
from paddle_tpu_torch.ops import fused_cross_entropy as tfce

B, S, H = 2, 5, 16


def _case(V, layout="vh", ignore=None, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((V, H)) * 0.3).astype(np.float32)
    if layout == "hv":
        w = np.ascontiguousarray(w.T)
    lab = rng.integers(0, V, (B, S)).astype(np.int32)
    if ignore is not None:
        lab[0, 1] = lab[1, -1] = ignore
    ct = rng.standard_normal((B, S)).astype(np.float32)
    return x, w, lab, ct


def _jax(x, w, lab, ct, xdt, wdt, **kw):
    def f(x_, w_):
        return jnp.sum(j_lce(x_, w_, jnp.asarray(lab), **kw) * ct)
    v, (gx, gw) = jax.jit(jax.value_and_grad(f, (0, 1)))(
        jnp.asarray(x, xdt), jnp.asarray(w, wdt))
    return float(v), np.asarray(gx, np.float32), np.asarray(gw, np.float32)


def _port(x, w, lab, ct, xdt, wdt, **kw):
    xt = torch.tensor(x).to(xdt).requires_grad_(True)
    wt = torch.tensor(w).to(wdt).requires_grad_(True)
    nll = tfce.linear_cross_entropy(xt, wt, torch.from_numpy(lab).long(),
                                    **kw)
    assert nll.dtype == torch.float32 and nll.shape == lab.shape
    loss = (nll * torch.from_numpy(ct)).sum()
    loss.backward()
    assert xt.grad.dtype == xdt and wt.grad.dtype == wdt
    return (float(loss.detach()), xt.grad.float().numpy(),
            wt.grad.float().numpy())


def _assert_match(got, ref, tol):
    np.testing.assert_allclose(got[0], ref[0], rtol=tol, atol=tol)
    for name, g, r in zip(("dx", "dw"), got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol, err_msg=name)


XLA_CASES = {
    "vh": dict(V=50, chunk=16),
    "hv": dict(V=50, chunk=16, layout="hv"),
    "hv-ignore-index": dict(V=40, chunk=16, layout="hv", ignore=-100),
    "smoothing-uneven": dict(V=37, chunk=16, label_smoothing=0.1),
}


@pytest.mark.parametrize("name", sorted(XLA_CASES))
def test_plain_matches_jax_xla_tier(name):
    c = dict(XLA_CASES[name])
    ignore = c.pop("ignore", None)
    x, w, lab, ct = _case(c.pop("V"), c.get("layout", "vh"), ignore)
    kw = dict(w_layout=c.pop("layout", "vh"), ignore_index=ignore, **c)
    ref = _jax(x, w, lab, ct, jnp.float32, jnp.float32, backend="xla", **kw)
    got = _port(x, w, lab, ct, torch.float32, torch.float32, **kw)
    _assert_match(got, ref, 1e-5)


@pytest.fixture
def pallas_interpret():
    from paddle_tpu.core.flags import FLAGS, set_flags
    old = FLAGS.pallas_interpret
    set_flags({"pallas_interpret": True})
    yield
    set_flags({"pallas_interpret": old})


def test_plain_matches_jax_pallas_kernels_fp32(pallas_interpret):
    """V 40 over chunks of 16: the last chunk is 8 wide, the kernel's
    padded columns must add nothing."""
    x, w, lab, ct = _case(40, ignore=-100, seed=1)
    kw = dict(chunk=16, ignore_index=-100)
    ref = _jax(x, w, lab, ct, jnp.float32, jnp.float32, backend="pallas",
               **kw)
    got = _port(x, w, lab, ct, torch.float32, torch.float32, **kw)
    _assert_match(got, ref, 1e-5)


def test_plain_matches_jax_pallas_kernels_bf16_head(pallas_interpret):
    """fp32 x with a bf16 head (grads fp32 / bf16), then all bf16."""
    x, w, lab, ct = _case(40, seed=2)
    for xdt, wdt, txdt in ((jnp.float32, jnp.bfloat16, torch.float32),
                           (jnp.bfloat16, jnp.bfloat16, torch.bfloat16)):
        ref = _jax(x, w, lab, ct, xdt, wdt, backend="pallas", chunk=16)
        got = _port(x, w, lab, ct, txdt, torch.bfloat16, chunk=16)
        _assert_match(got, ref, 2e-2)


def test_chunk_width_moves_only_the_summation_order():
    x, w, lab, ct = _case(37, ignore=-100, seed=3)
    kw = dict(ignore_index=-100, label_smoothing=0.05)
    ref = _port(x, w, lab, ct, torch.float32, torch.float32, chunk=37, **kw)
    for chunk in (1, 8, 36):
        _assert_match(_port(x, w, lab, ct, torch.float32, torch.float32,
                            chunk=chunk, **kw), ref, 1e-5)
    assert tfce.default_chunk(1000) == 1000 and \
        tfce.default_chunk(32000) == 2048
    assert tfce.chunked_peak_bytes(8192, 32000) < \
        tfce.naive_peak_bytes(8192, 32000)


def test_refusals():
    x, w = torch.zeros(2, 3, H), torch.zeros(10, H)
    lab = torch.zeros(2, 3, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 17"):
        tfce.linear_cross_entropy(x, w, lab, axis_name="mp")
    with pytest.raises(ValueError, match="w_layout"):
        tfce.linear_cross_entropy(x, w, lab, w_layout="xy")
    with pytest.raises(ValueError, match="hidden size"):
        tfce.linear_cross_entropy(x, w, lab, w_layout="hv")
