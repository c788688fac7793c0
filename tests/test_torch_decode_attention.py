"""The port's decode attention against the JAX package's.

The same inputs, made with numpy, go through the JAX reference
(``decode_attention_ref``, p kept in fp32) and the JAX Pallas kernel run
in interpret mode on one side, and the port's plain version on the other:

* fp32 against the JAX reference: 1e-5 (the port's blocked softmax and
  the reference's global one differ only in fp32 rounding);
* fp32 against the interpret-mode kernel: 1e-5; bf16: 2e-2 (both round p
  to bf16 before p @ v; the sums run in another order);
* MHA and GQA, T off the 512-row block (T 600: two blocks, the second
  ragged) and ragged lengths, 1 and T included.

The dispatch sends CPU tensors to the plain version and refuses
malformed inputs by name.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import decode_attention as jda
from paddle_tpu_torch.ops import decode_attention as tda

# (label, B, Hq, Hkv, D, T, lengths)
CASES = [
    ("mha", 2, 4, 4, 16, 40, (1, 40)),
    ("gqa", 3, 8, 2, 32, 100, (7, 100, 1)),
    ("T 600 ragged", 2, 4, 2, 16, 600, (600, 513)),
]
IDS = [c[0] for c in CASES]
# the interpret-mode kernel is slow: one GQA grid across two T blocks
KERNEL_CASES = [CASES[0], CASES[2]]


def _inputs(case, seed=0):
    _, B, Hq, Hkv, D, T, lengths = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def _port(q, k, v, lengths, dt):
    t = [torch.from_numpy(a.copy()).to(dt) for a in (q, k, v)]
    return tda.decode_attention(*t, torch.from_numpy(lengths.copy())) \
        .float().numpy()


def _jax_dt(a, dt):
    return jnp.asarray(a.astype(ml_dtypes.bfloat16) if dt == "bf16" else a)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_jax_reference_fp32(case):
    q, k, v, lengths = _inputs(case)
    ref = np.asarray(jda.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)))
    np.testing.assert_allclose(_port(q, k, v, lengths, torch.float32), ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt,tol", [("fp32", 1e-5), ("bf16", 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in
                                                    KERNEL_CASES])
def test_plain_matches_jax_interpret_kernel(case, dt, tol):
    q, k, v, lengths = _inputs(case, seed=1)
    if dt == "bf16":        # both sides see the same bf16 values
        q, k, v = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                   for a in (q, k, v))
    ref = np.asarray(jda.decode_attention(
        _jax_dt(q, dt), _jax_dt(k, dt), _jax_dt(v, dt), jnp.asarray(lengths),
        use_pallas=True)).astype(np.float32)
    got = _port(q, k, v, lengths,
                torch.bfloat16 if dt == "bf16" else torch.float32)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_p_is_rounded_to_the_cache_dtype_before_p_v():
    """bf16: the plain version rounds p before p @ v (the Pallas kernel's
    rounding point); keeping p in fp32, as the JAX reference does, gives
    other values."""
    q, k, v, lengths = _inputs(CASES[1], seed=2)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    lt = torch.from_numpy(lengths)
    got = tda.decode_attention_ref(qb, kb, vb, lt).float()
    B, Hq, D = q.shape
    G = Hq // k.shape[2]
    s = torch.einsum("bkgd,btkd->bkgt", qb.float().reshape(B, -1, G, D),
                     kb.float()) / D ** 0.5
    s = torch.where(torch.arange(s.shape[-1]) < lt[:, None, None, None], s,
                    -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))       # T <= 512: one block
    l = p.sum(-1, keepdim=True)
    exact = (torch.einsum("bkgt,btkd->bkgd", p.to(torch.bfloat16).float(),
                          vb.float()) / l).reshape(B, Hq, D).to(torch.bfloat16)
    fp32_p = (torch.einsum("bkgt,btkd->bkgd", p, vb.float()) / l).reshape(
        B, Hq, D).to(torch.bfloat16)
    torch.testing.assert_close(got, exact.float(), rtol=0, atol=0)
    assert not torch.equal(got, fp32_p.float())


@pytest.mark.parametrize("bad", ["kv heads", "lengths", "head dim"])
def test_malformed_inputs_raise(bad):
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(2, 8, 3 if bad == "kv heads" else 2, 16)
    lengths = torch.ones(3 if bad == "lengths" else 2, dtype=torch.int32)
    if bad == "head dim":
        q = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError):
        tda.decode_attention(q, k, k.clone(), lengths)
