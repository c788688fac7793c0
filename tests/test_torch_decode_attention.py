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

The card's kernel splits each (sequence, kv head)'s rows over a cluster
of S blocks and exchanges the 512-row block's max between them before
any p is formed; a test-local torch model of that arithmetic (S = 1, 3,
4 and 8 parts, peers' maxes and sums taken in rank order) gives p
bit-identical to the plain version's and its output within fp32 1e-6
(only the order of the fp32 sums of l and acc differs).
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


# ------------------------------------------- the kernel's split arithmetic
SPLIT_CASES = [CASES[1], CASES[2],
               ("T 600 with a length-0 row", 2, 4, 2, 16, 600, (0, 300))]


def _scores(q, k_cache, scale):
    """The plain version's fp32 scores [B, Hkv, G, T], by its expression."""
    B, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    return (qg @ k_cache.float().permute(0, 2, 3, 1)) * scale


def _plain_p(q, k_cache, lengths, scale):
    """p = exp(s - m) as the plain version forms it (the running max over
    whole 512-row blocks, masked scores NEG_INF), rounded to the cache's
    dtype: [B, Hkv, G, T]."""
    T = k_cache.shape[1]
    scores = _scores(q, k_cache, scale)
    keep = (torch.arange(T)[None, :] < lengths.long()[:, None])[:, None,
                                                                 None, :]
    scores = torch.where(keep, scores, tda.NEG_INF)
    m = torch.full(scores.shape[:-1] + (1,), tda.NEG_INF)
    ps = []
    for t0 in range(0, T, tda.BLOCK_T):
        blk = scores[..., t0:t0 + tda.BLOCK_T]
        m = torch.maximum(m, blk.amax(-1, keepdim=True))
        ps.append(torch.exp(blk - m))
    return torch.cat(ps, -1).to(k_cache.dtype)


def _split_model(q, k_cache, v_cache, lengths, scale, S, exchange=True):
    """The card kernel's arithmetic with the rows of each (b, kv head) cut
    into S parts: part r takes rows [t0 + r c, t0 + (r+1) c) of each
    512-row block t0 (c = ceil(min(T, 512) / S)), clipped to the length (a
    length-0 row attends all T rows, each score NEG_INF); the block's max
    is the max of the parts' maxes (``exchange=False``: each part's own);
    each part keeps its own (l, acc), rescaled per block, and the parts are
    summed in rank order.  Returns fp32 ``out`` [B, Hq, D] and the rounded
    p [B, Hkv, G, T] of the rows formed (0 elsewhere)."""
    B, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    c = -(-min(T, tda.BLOCK_T) // S)
    scores = _scores(q, k_cache, scale)
    vt = v_cache.transpose(1, 2).float()                   # [B, Hkv, T, D]
    out = torch.zeros(B, Hkv, G, D)
    p_out = torch.zeros(B, Hkv, G, T, dtype=k_cache.dtype)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), T)
        rows = T if n == 0 else n
        sc = scores[b] if n else torch.full_like(scores[b], tda.NEG_INF)
        m = torch.full((Hkv, G, 1), tda.NEG_INF)
        l = [torch.zeros(Hkv, G, 1) for _ in range(S)]
        acc = [torch.zeros(Hkv, G, D) for _ in range(S)]
        for t0 in range(0, rows, tda.BLOCK_T):
            spans = [(t0 + r * c, min(t0 + (r + 1) * c, t0 + tda.BLOCK_T,
                                      rows)) for r in range(S)]
            maxes = [sc[..., lo:hi].amax(-1, keepdim=True) if hi > lo
                     else torch.full((Hkv, G, 1), tda.NEG_INF)
                     for lo, hi in spans]
            mb = maxes[0]
            for x in maxes[1:]:
                mb = torch.maximum(mb, x)
            m_new = torch.maximum(m, mb)
            alpha = torch.exp(m - m_new)
            for r, (lo, hi) in enumerate(spans):
                mr = m_new if exchange else torch.maximum(m, maxes[r])
                p = torch.exp(sc[..., lo:hi] - mr)
                pr = p.to(v_cache.dtype)
                p_out[b, ..., lo:hi] = pr
                l[r] = alpha * l[r] + p.sum(-1, keepdim=True)
                acc[r] = alpha * acc[r] + pr.float() @ vt[b, :, lo:hi]
            m = m_new
        lt, at = l[0], acc[0]
        for r in range(1, S):
            lt, at = lt + l[r], at + acc[r]
        out[b] = at / lt.clamp_min(1e-30)
    return out.reshape(B, Hq, D), p_out


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("S", [1, 3, 4, 8])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in
                                                   SPLIT_CASES])
def test_cluster_split_matches_plain(case, S, dt):
    """p bit-identical to the plain version's on every row the kernel
    forms, the output within fp32 1e-6 of the plain version run with an
    fp32 q (so its output is not rounded; p is still rounded to the
    cache's dtype); and without the exchange of the 512-row max the
    rounded p of a split would differ."""
    q, k, v, lengths = _inputs(case, seed=3)
    qt, kt, vt = (torch.from_numpy(a.copy()).to(dt) for a in (q, k, v))
    lt = torch.from_numpy(lengths.copy())
    scale = 1.0 / q.shape[-1] ** 0.5
    got, p = _split_model(qt, kt, vt, lt, scale, S)
    ref_p = _plain_p(qt, kt, lt, scale)
    T = k.shape[1]
    for b, n in enumerate(lengths):
        rows = T if n == 0 else min(int(n), T)
        assert torch.equal(p[b, ..., :rows], ref_p[b, ..., :rows])
    want = tda.decode_attention_ref(qt.float(), kt, vt, lt, scale)
    assert want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if S > 1:
        _, p_local = _split_model(qt, kt, vt, lt, scale, S, exchange=False)
        assert not torch.equal(p_local, p)
