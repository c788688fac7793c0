"""The engine's sampled decoding against JAX 0.9.0 (``jax_threefry_
partitionable`` on): the key chain ``fold_in(key(seed), position)``, the
raw bits of a ``(V,)`` draw and ``uniform`` bit for bit, the Gumbel noise
to one ulp a ``log`` (torch's and XLA's ``log`` may round apart), the
per-sample seeds, and the sampler's ids over the same logits rows —
temperature, top-k with its ties kept, top-p over the top-k-filtered
distribution — for many seeds, equal to ``paddle_tpu``'s
``build_sampler``.  Also the engine-level rules of
``tests/test_serving_engine.py``: the filters filter, top-p follows
top-k, a request without temperature decodes greedily, and a sampled
request's tokens do not depend on its batchmates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import parallel as dist
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import GenRequest as JRequest
from paddle_tpu.inference.serving import build_sampler as jbuild_sampler
from paddle_tpu.inference.serving import derive_sample_seed as jderive
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel.topology import HybridTopology, set_topology
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                GenRequest, build_sampler,
                                                derive_sample_seed)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import threefry as tf

TINY = np.finfo(np.float32).tiny


@pytest.fixture(scope="module")
def model():
    cfg = jllama.llama_tiny()
    topo = dist.init_topology(devices=jax.devices()[:1])
    _, init_fn = jllama.build_llama_train_step(cfg, topo,
                                               num_microbatches=1)
    params = init_fn(0)["params"]
    set_topology(HybridTopology())
    return cfg, params, jax.tree_util.tree_map(np.asarray, params)


def _engine(np_tree, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 64)
    return ContinuousBatchingEngine(
        tllama.llama_tiny(), params_from_numpy(np_tree, "float32", "cpu"),
        device="cpu", **kw)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


KEYS = [(0, 0), (3, 7), (-5, 100), (2 ** 31 - 1, 12345), (123456, 2 ** 31 + 5)]


@pytest.mark.parametrize("seed,pos", KEYS)
def test_key_chain_bits_and_uniform_match_jax(seed, pos):
    key = jax.random.fold_in(jax.random.key(seed), pos)
    words = tf.fold_in(tf.prng_key(seed), pos)
    assert tuple(int(w) for w in jax.random.key_data(key)) == words
    want = np.asarray(jax.random.bits(key, (4099,), jnp.uint32))
    got = tf.random_bits(*words, 4099)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # one key a row gives each row's own draw
    rows = tf.random_bits(torch.tensor([[words[0]], [0]]),
                          torch.tensor([[words[1]], [seed & 0xFFFFFFFF]]),
                          4099)
    np.testing.assert_array_equal(rows[0].numpy(), want.astype(np.int64))
    u = np.asarray(jax.random.uniform(key, (4099,), minval=TINY, maxval=1.0))
    np.testing.assert_array_equal(tf.uniform(got).numpy(), u)


@pytest.mark.parametrize("seed", [0, 1, 29])
def test_gumbel_noise_within_one_ulp_a_log(seed):
    """The noise is ``-log(-log(u))`` with ``u`` bit-equal; each ``log``
    of torch is within one ulp of XLA's on the same input, so the noise
    is within 2^-20 of ``jax.random.gumbel``'s."""
    key = jax.random.fold_in(jax.random.key(seed), 11)
    bits = tf.random_bits(*tf.fold_in(tf.prng_key(seed), 11), 50000)
    u = tf.uniform(bits)
    inner_t = -torch.log(u)
    inner_j = np.asarray(-jnp.log(jnp.asarray(u.numpy())))
    assert _ulps(inner_t.numpy(), inner_j).max() <= 1
    outer_t = -torch.log(torch.from_numpy(inner_j.copy()))
    assert _ulps(outer_t.numpy(), np.asarray(-jnp.log(inner_j))).max() <= 1
    want = np.asarray(jax.random.gumbel(key, (50000,)))
    np.testing.assert_allclose(tf.gumbel(bits).numpy(), want, rtol=0,
                               atol=2.0 ** -20)


@pytest.mark.parametrize("seed,idx", [(7, 0), (7, 1), (7, 5),
                                      (2 ** 31 - 1, 3)])
def test_derive_sample_seed_matches_jax(seed, idx):
    assert derive_sample_seed(seed, idx) == jderive(seed, idx)


# (temperature, top_k, top_p) per row: no filter, top-k past V, top-p of
# 1.0 (a cumulative sum that may never reach it), both filters
SAMPLER_CASES = {
    "temperature": [(0.8, 0, 0.0), (1.3, 0, 0.0)],
    "top_k": [(1.0, 20, 0.0), (0.5, 1, 0.0), (1.0, 300, 0.0)],
    "top_p": [(1.0, 0, 0.9), (0.7, 0, 1.0), (1.0, 0, 0.05)],
    "top_k_top_p": [(0.8, 50, 0.9), (1.0, 2, 0.95), (1.2, 10, 0.5)],
    "ties": [(1.0, 3, 0.0), (1.0, 3, 0.9), (0.6, 4, 0.8)],
}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_ids_match_jax(case):
    """Over the same fp32 logits rows, 32 seeds a row set, the port's
    sampler draws JAX's ids.  ``ties``: rows whose k-th largest value is
    shared by several tokens (all of them stay)."""
    rows = SAMPLER_CASES[case]
    n, V = len(rows), 256
    jsample = jax.jit(jbuild_sampler())
    tsample = build_sampler()
    g = np.random.default_rng(len(case))
    for trial in range(32):
        lg = (g.standard_normal((n, V)) * 3).astype(np.float32)
        if case == "ties":
            lg[:, [5, 9, 17, 40]] = lg.max() + 1.0
            lg[:, [3, 4]] = lg.max()
        seeds = g.integers(0, 2 ** 31 - 1, n).astype(np.int32)
        pos = g.integers(0, 4096, n).astype(np.int32)
        t, k, p = (np.asarray(c, d) for c, d in
                   zip(zip(*rows), (np.float32, np.int32, np.float32)))
        want = np.asarray(jsample(lg, seeds, pos, t, k, p))
        got = tsample(torch.from_numpy(lg), seeds.tolist(), pos.tolist(),
                      t.tolist(), k.tolist(), p.tolist())
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{trial}")


def test_top_k_keeps_ties():
    """``x < kth -> -inf`` keeps every token tied with the k-th value
    (``torch.topk`` would keep k of them): with top_k 2 and three tokens
    at the top, all three are drawn."""
    V = 64
    lg = np.full((1, V), -5.0, np.float32)
    lg[0, [7, 8, 30]] = 3.0
    sample = build_sampler()
    ids = {int(sample(torch.from_numpy(lg), [s], [0], [1.0], [2], [0.0]))
           for s in range(60)}
    assert ids == {7, 8, 30}


def test_engine_sample_rows_match_jax_engine(model):
    """The engine's sampled sub-batch (4 rows, 4 seeds) against the JAX
    engine's padded fixed-width sampler over the same rows."""
    cfg, params, np_tree = model
    jeng = JEngine(cfg, params, max_batch=4, block_size=8, num_blocks=16)
    teng = _engine(np_tree, max_batch=4)
    g = np.random.default_rng(4)
    lg = g.standard_normal((4, cfg.vocab_size)).astype(np.float32) * 2
    specs = [(0.8, 20, 0.9, 1), (1.0, None, 0.95, 2), (0.7, 5, None, 3),
             (1.2, 50, 0.8, 4)]
    pos = [17, 3, 250, 64]
    jreqs = [JRequest(i, np.zeros(1, np.int32), 4, temperature=t, top_k=k,
                      top_p=p, seed=s) for i, (t, k, p, s) in enumerate(specs)]
    treqs = [GenRequest(i, np.zeros(1, np.int32), 4, temperature=t, top_k=k,
                        top_p=p, seed=s) for i, (t, k, p, s) in enumerate(specs)]
    want = jeng._sample_rows(jreqs, lg, pos)
    np.testing.assert_array_equal(
        teng._sample_rows(treqs, torch.from_numpy(lg), pos), want)
    for r, row, p, w in zip(treqs, lg, pos, want):
        assert teng._pick_token(r, row, position=p) == w


def test_sampler_topk_filter_actually_filters(model):
    eng = _engine(model[2], max_batch=1, num_blocks=32)
    logits = np.full((256,), -10.0, np.float32)
    logits[5], logits[9] = 4.0, 3.9
    req = GenRequest(0, np.zeros(1, np.int32), 4, temperature=1.0, top_k=2,
                     seed=0)
    picks = {eng._pick_token(req, logits, position=p) for p in range(64)}
    assert picks <= {5, 9} and len(picks) == 2, picks


def test_topp_applies_after_topk(model):
    """Top-p mass is taken over the top-k-filtered distribution: with
    top_k 2 and top_p 0.95 only the argmax survives."""
    eng = _engine(model[2], max_batch=1, num_blocks=32)
    logits = np.zeros((256,), np.float32)
    logits[5], logits[9] = 8.0, 4.0
    req = GenRequest(0, np.zeros(1, np.int32), 4, temperature=1.0, top_k=2,
                     top_p=0.95, seed=0)
    picks = {eng._pick_token(req, logits, position=p) for p in range(64)}
    assert picks == {5}, picks


def test_filters_without_temperature_decode_greedily(model):
    prompt = np.random.default_rng(1).integers(0, 256, 11).astype(np.int32)
    outs = []
    for kw in ({}, {"top_k": 5, "top_p": 0.5, "seed": 9},
               {"temperature": 0.0, "top_k": 3}):
        eng = _engine(model[2], max_batch=1)
        rid = eng.add_request(prompt, 6, **kw)
        outs.append(eng.run_to_completion()[rid])
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_sampled_requests_independent_of_batch(model):
    """A sampled request's tokens are the same alone or beside another
    request (keys by seed and absolute position), and another seed
    gives other tokens."""
    g = np.random.default_rng(2)
    prompt = g.integers(0, 256, 6).astype(np.int32)
    mate = g.integers(0, 256, 9).astype(np.int32)

    def run(batchmates, seed):
        eng = _engine(model[2])
        rid = eng.add_request(prompt, 6, temperature=0.8, top_k=20,
                              seed=seed)
        for bp in batchmates:
            eng.add_request(bp, 4)
        return eng.run_to_completion()[rid]

    solo = run([], 7)
    np.testing.assert_array_equal(solo, run([mate], 7))
    assert not np.array_equal(solo, run([], 8))
