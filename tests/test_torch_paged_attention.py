"""The card's paged attention splits each row's live pages over up to 8
blocks of a cluster and folds their softmax states in rank order
(``kernels/csrc/paged_attention.cu``).  Its plain model,
``paged_attention_split_ref``, must equal the port's plain version
``paged_attention_ref`` and the JAX package's references (decode:
``ops.paged_kv.paged_decode_attention``; prefill: the dense masked
attention of ``models.generation``, as ``prefill_block_xla`` runs it) at
fp32 1e-5, for every split count 1..8.  The same inputs, made with numpy
from a seed, go to both packages."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.generation import _dense_masked_attention
from paddle_tpu.ops import paged_kv as jkv
from paddle_tpu_torch.ops.cuda import kernels as K

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import pattn_ab  # noqa: E402

NB, BS, HKV, D = 40, 4, 2, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _pools(rng):
    return [rng.standard_normal((NB, BS, HKV, D)).astype(np.float32)
            for _ in range(2)]


def _decode_case(G):
    """Rows at lengths 0, 3, 4, 5 (around one page), 37 (ten pages, every
    split), and 19 over a table with unmapped (-1) entries past its pages
    and inside the live ones."""
    rng = np.random.default_rng(11)
    pk, pv = _pools(rng)
    lengths = np.array([0, 3, 4, 5, 37, 19], np.int32)
    bt = np.full((6, 12), -1, np.int32)
    perm = rng.permutation(NB)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-(n + 1) // BS)
        bt[b, :need] = perm[used:used + need]
        used += need
    bt[5, 2] = -1
    q = rng.standard_normal((6, HKV * G, D)).astype(np.float32)
    return q, pk, pv, bt, lengths


def _prefill_case(G):
    rng = np.random.default_rng(12)
    pk, pv = _pools(rng)
    Ts, start = 7, 22
    bt = np.full(10, -1, np.int32)
    bt[:8] = rng.permutation(NB)[:8]
    q = rng.standard_normal((Ts, HKV * G, D)).astype(np.float32)
    return q, pk, pv, bt, start


@pytest.fixture(scope="module")
def decode_refs():
    """{G: (case, JAX decode attention [B, Hq * D])}."""
    out = {}
    for G in (1, 2, 4):
        q, pk, pv, bt, lengths = _decode_case(G)
        ref = jax.jit(jkv.paged_decode_attention)(
            jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(bt), jnp.asarray(lengths + 1))
        out[G] = ((q, pk, pv, bt, lengths),
                  np.asarray(ref, np.float32).reshape(len(q), -1))
    return out


@pytest.fixture(scope="module")
def prefill_refs():
    out = {}
    for G in (1, 4):
        q, pk, pv, bt, start = _prefill_case(G)
        Ts, T = q.shape[0], bt.shape[0] * BS
        mask = (np.arange(T)[None, :] <= start + np.arange(Ts)[:, None])
        kk = pk[np.maximum(bt, 0)].reshape(1, T, HKV, D)
        vv = pv[np.maximum(bt, 0)].reshape(1, T, HKV, D)
        ref = jax.jit(_dense_masked_attention, static_argnums=4)(
            jnp.asarray(q[None]), jnp.asarray(kk), jnp.asarray(vv),
            jnp.asarray(mask[None, None]), 1.0 / D ** 0.5)
        out[G] = ((q, pk, pv, bt, start),
                  np.asarray(ref, np.float32).reshape(Ts, -1))
    return out


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("splits", range(1, 9))
def test_split_fold_matches_plain_and_jax_at_decode(decode_refs, G, splits):
    (q, pk, pv, bt, lengths), jax_ref = decode_refs[G]
    args = dict(block_table=torch.from_numpy(bt),
                lengths=torch.from_numpy(lengths))
    qt = torch.from_numpy(q.reshape(len(q), -1))
    pkt, pvt = torch.from_numpy(pk), torch.from_numpy(pv)
    got = K.paged_attention_split_ref(qt, pkt, pvt, splits=splits, **args)
    torch.testing.assert_close(got, K.paged_attention_ref(qt, pkt, pvt,
                                                          **args), **TOL)
    np.testing.assert_allclose(got.numpy(), jax_ref, **TOL)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("splits", range(1, 9))
def test_split_fold_matches_plain_and_jax_at_prefill(prefill_refs, G,
                                                     splits):
    (q, pk, pv, bt, start), jax_ref = prefill_refs[G]
    qt = torch.from_numpy(q.reshape(len(q), -1))
    pkt, pvt = torch.from_numpy(pk), torch.from_numpy(pv)
    args = dict(block_table=torch.from_numpy(bt), start=start)
    got = K.paged_attention_split_ref(qt, pkt, pvt, splits=splits, **args)
    torch.testing.assert_close(got, K.paged_attention_ref(qt, pkt, pvt,
                                                          **args), **TOL)
    np.testing.assert_allclose(got.numpy(), jax_ref, **TOL)



@pytest.mark.parametrize("variant", sorted(pattn_ab.TUNINGS))
def test_pattn_ab_tunings_apply_to_the_source(variant):
    """Each of the A/B tool's tunings edits this tree's kernel source."""
    name = pattn_ab.TUNED_FILE.get(variant, "paged_attention.cu")
    src = (ROOT / "paddle_tpu_torch/kernels/csrc" / name).read_text()
    assert pattn_ab._edited(src, pattn_ab.TUNINGS[variant]) != src
