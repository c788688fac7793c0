"""The port's engine at the JAX engine's defaults (prefix caching on,
preemption on, ``prefill_buckets=None``) against the JAX engine on
``llama_tiny``, and the prefix cache on its own.

The same parameters (through ``bridge.params_from_numpy``) and one
shared-prefix, mixed-priority, partly sampled workload must give the
same token ids, fp32 decode logits to 1e-4, and equal ``stats``,
``prefix_stats()``, ``resilience_stats()`` (but the spill seconds) and
``kv_leak_report()`` — in fp32 and bf16, with buckets, an int8 KV pool,
int8 weights, and a zero-capacity spill tier with a host offload tier.
The radix tree and its offload tier are held against the JAX class; the
engine paths of ``tests/test_serving_engine.py`` (prefix reuse, dense
and chunk prefill, eviction, cancellation and crash accounting) are
mirrored on the port."""

import jax
import numpy as np
import pytest
import torch

import faults

from paddle_tpu import parallel as dist
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import build_sampler as jbuild_sampler
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel.topology import HybridTopology, set_topology
from paddle_tpu.quantization import ServeQuantConfig as JQuant
from paddle_tpu.serving import prefix_cache as jpc
from paddle_tpu.serving.resilience import SpillTier as JSpillTier
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                _RefPool)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.quantization import ServeQuantConfig
from paddle_tpu_torch.serving import (PrefixCache, PrefixCacheConfig,
                                      SpillCorruptError, SpillTier,
                                      block_keys)

BS = 8
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (temperature, top_k, top_p, seed) of the workload's sampled requests;
# request 0 asks for top_k with no temperature and decodes greedily
SAMPLED = {1: (0.8, 20, 0.9, 11), 2: (1.0, None, 0.95, 12),
           4: (0.7, 5, None, 13), 5: (1.2, 50, 0.8, 14)}
PRIORITIES = (0, 0, 0, 2, 1, 0)

rng = np.random.default_rng(25)


def _init(dtype):
    cfg = jllama.llama_tiny(dtype=dtype)
    topo = dist.init_topology(devices=jax.devices()[:1])
    _, init_fn = jllama.build_llama_train_step(cfg, topo,
                                               num_microbatches=1)
    params = init_fn(0)["params"]
    set_topology(HybridTopology())
    return cfg, params, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def model():
    return _init("float32")


@pytest.fixture(scope="module")
def model_bf16():
    return _init("bfloat16")


def _engine(np_tree, dtype="float32", **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("block_size", BS)
    kw.setdefault("num_blocks", 64)
    return ContinuousBatchingEngine(
        tllama.llama_tiny(dtype=dtype),
        params_from_numpy(np_tree, dtype, "cpu"), device="cpu", **kw)


def _cold(np_tree, prompt, max_new, **req_kw):
    """The cold-miss reference: caching and preemption off."""
    eng = _engine(np_tree, max_batch=1, enable_prefix_caching=False,
                  enable_preemption=False)
    rid = eng.add_request(prompt, max_new, **req_kw)
    return eng.run_to_completion()[rid]


def _prompt(n, base=None):
    p = rng.integers(0, 256, (n,)).astype(np.int32)
    return p if base is None else np.concatenate([base, p])


def _assert_pool_consistent(eng):
    """Every page free XOR referenced; each refcount equals the slots
    holding it plus one if the prefix index parks it."""
    held = {}
    for pages in eng.slot_pages:
        for p in pages:
            held[p] = held.get(p, 0) + 1
    for p in eng.prefix_index.values():
        held[p] = held.get(p, 0) + 1
    free = set(eng.alloc._free)
    for p, r in eng.alloc.ref.items():
        assert p not in free, f"block {p} free AND ref={r}"
        assert held.get(p, 0) == r, (p, r, held.get(p, 0))
    for p in held:
        assert p in eng.alloc.ref, f"block {p} held but unreferenced"
    assert len(free) + len(eng.alloc.ref) == eng.alloc.num_blocks
    rep = eng.kv_leak_report()
    assert rep["leaked"] == 0 and rep["unaccounted"] == 0, rep


# ---------------------------------------------------------------------
# the engine at its defaults against the JAX engine
# ---------------------------------------------------------------------
def _workload():
    wl = np.random.default_rng(3)
    prefix = wl.integers(0, 256, 24).astype(np.int32)
    out = []
    for i in range(6):
        p = np.concatenate([prefix,
                            wl.integers(0, 256, 3 + 8 * (i % 2)).astype(np.int32)])
        kw = {"priority": PRIORITIES[i]}
        if i in SAMPLED:
            t, k, tp, s = SAMPLED[i]
            kw.update(temperature=t, top_k=k, top_p=tp, seed=s)
        elif i == 0:
            kw.update(top_k=5, top_p=0.5, seed=3)
        out.append((p, 6 + i, kw))
    return out


PARITY = {
    "fp32": {},
    "bf16": {"dtype": "bfloat16"},
    "fp32_int8_kv": {"quant": {"kv_dtype": "int8"}},
    "bf16_int8_kv": {"dtype": "bfloat16", "quant": {"kv_dtype": "int8"}},
    "fp32_buckets": {"prefill_buckets": (8,)},
    "fp32_int8_weights": {"quant": {"weight_dtype": "int8"}},
    # every spill dropped (replay from the prefix) and prefix pages
    # evicted into the host tier (restored by bytes) on a tight pool
    "fp32_replay_offload": {"spill": 0, "offload": 1 << 20,
                            "num_blocks": 8},
}


def _stats(eng):
    res = {k: v for k, v in eng.resilience_stats().items()
           if not k.endswith("_secs")}
    return (dict(eng.stats), eng.prefix_stats(), res, eng.kv_leak_report())


def _first_token_divergence(jeng, teng):
    """(request id, token index) of the first token the two engines'
    live slots disagree on, or None."""
    for s in range(jeng.B):
        a, b = jeng.slots[s], teng.slots[s]
        assert (a is None) == (b is None)
        if a is not None and a.out != b.out:
            assert a.req_id == b.req_id
            i = next(i for i, (x, y) in enumerate(zip(a.out, b.out))
                     if x != y)
            return s, a, b, i
    return None


@pytest.mark.parametrize("name", list(PARITY))
def test_engine_at_defaults_matches_jax_engine(model, model_bf16, name):
    c = PARITY[name]
    dtype = c.get("dtype", "float32")
    cfg, params, np_tree = model_bf16 if dtype == "bfloat16" else model
    kw = {"max_batch": 2, "block_size": BS,
          "num_blocks": c.get("num_blocks", 16)}
    jkw, tkw = dict(kw), dict(kw)
    if "prefill_buckets" in c:
        jkw["prefill_buckets"] = tkw["prefill_buckets"] = \
            c["prefill_buckets"]
    if "quant" in c:
        jkw["quant_config"] = JQuant(**c["quant"])
        tkw["quant_config"] = ServeQuantConfig(**c["quant"])
    if "spill" in c:
        jkw["spill_tier"] = JSpillTier(capacity_bytes=c["spill"])
        tkw["spill_tier"] = SpillTier(capacity_bytes=c["spill"])
    if "offload" in c:
        jkw["prefix_cache_config"] = jpc.PrefixCacheConfig(
            offload_capacity_bytes=c["offload"])
        tkw["prefix_cache_config"] = PrefixCacheConfig(
            offload_capacity_bytes=c["offload"])
    jeng = JEngine(cfg, params, **jkw)
    teng = _engine(np_tree, dtype, **tkw)
    work = _workload()
    jres, tres, diverged = {}, {}, {}
    for step in range(400):
        if step < len(work):
            p, n, rkw = work[step]
            assert jeng.add_request(p, n, **rkw) == \
                teng.add_request(p, n, **rkw)
        jres.update(jeng.step())
        tres.update(teng.step())
        if jeng.last_logits is None:
            assert teng.last_logits is None
        else:
            np.testing.assert_allclose(teng.last_logits, jeng.last_logits,
                                       rtol=TOL[dtype], atol=TOL[dtype])
        d = _first_token_divergence(jeng, teng)
        if d is not None:
            # bf16 over an int8 pool: a sampled row at a near tie of the
            # top-p cutoff (ROADMAP queue 3).  The JAX sampler on the
            # port's logits row draws the port's token, so the sampler
            # agrees and the logits (within TOL) made the difference
            s, a, b, i = d
            assert name == "bf16_int8_kv" and a.req_id in SAMPLED, d
            assert i == len(a.out) - 1 and a.req_id not in diverged
            r = teng.slots[s]
            pos = int(teng.lengths[s])
            tok = jax.jit(jbuild_sampler())(
                teng.last_logits[s][None], np.int32([r.seed]),
                np.int32([pos]), np.float32([r.temperature]),
                np.int32([r.top_k or 0]), np.float32([r.top_p or 0.0]))
            assert int(tok[0]) == b.out[i]
            diverged[a.req_id] = i
            a.out[i] = b.out[i]          # continue both on one stream
            jeng.tokens[s] = b.out[i]
        if step >= len(work) and not jeng.queue and \
                not any(s is not None for s in jeng.slots):
            break
    tres.update(teng.run_to_completion())
    assert sorted(jres) == sorted(tres) == list(range(len(work)))
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], jres[rid])
    assert _stats(teng) == _stats(jeng)
    assert jeng.prefix_stats()["hits"] >= 4
    assert jeng.resilience_stats()["preemptions"] >= 1
    if "spill" in c:
        assert jeng.resilience_stats()["prefix_replays"] >= 1
        assert jeng.prefix_stats()["offloads"] >= 1
        assert jeng.prefix_stats()["restores"] >= 1, jeng.prefix_stats()
    _assert_pool_consistent(teng)


# ---------------------------------------------------------------------
# the radix tree and its host tier against the JAX class
# ---------------------------------------------------------------------
@pytest.mark.parametrize("n,bs", [(0, 4), (3, 4), (5, 16)])
def test_block_keys_match_jax(n, bs):
    toks = rng.integers(0, 32000, n * bs + 3).astype(np.int32)
    assert block_keys(toks, n, bs) == jpc.block_keys(toks, n, bs)
    assert PrefixCache(bs).keys_for(toks.tolist(), n) == \
        jpc.PrefixCache(bs).keys_for(toks, n)


def _radix_ops(cache, keys, blk, wrap):
    """One sequence of inserts, walks, evictions, offloads and
    promotions; returns everything observable."""
    seen = [cache.insert(keys, [10, 11, 12]), cache.insert(keys, [20, 21]),
            cache.match_blocks(keys)]
    refs = {10: 1, 11: 1, 12: 1}
    victim = cache.evictable(lambda p: refs[p])
    seen.append(victim.phys)
    seen.append(cache.evict(victim, wrap(blk + 1), wrap(blk + 2)))
    pages, off = cache.walk(keys)
    seen += [pages, len(off), cache.match_blocks(keys)]
    refs[11] = 2
    seen.append(cache.evictable(lambda p: refs[p]).phys)
    v2 = cache.evictable(lambda p: refs[p])
    cache.evict(v2, wrap(blk), wrap(blk))
    seen += [cache.offloaded_blocks, cache.host_bytes]
    refs[11] = 1
    v3 = cache.evictable(lambda p: refs[p])
    seen.append(v3.phys)
    cache.evict(v3)
    pages, off = cache.walk(keys)
    seen += [pages, [n.depth for n in off]]
    seen.append(cache.insert(keys, [30, 31, 32]))
    seen += [cache.resident_items(), dict(cache.stats)]
    return seen


def test_radix_tree_matches_jax_op_for_op():
    toks = np.arange(12, dtype=np.int32)
    keys = block_keys(toks, 3, 4)
    blk = np.zeros((2, 4, 1, 2), np.float32)
    cap = 3 * blk.nbytes
    jseen = _radix_ops(jpc.PrefixCache(4, jpc.PrefixCacheConfig(cap)),
                       keys, blk, lambda a: a.copy())
    tseen = _radix_ops(PrefixCache(4, PrefixCacheConfig(cap)), keys, blk,
                       lambda a: torch.from_numpy(a.copy()))
    assert tseen == jseen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"])
def test_offloaded_block_crc_is_the_jax_crc(dtype):
    """An offloaded block's CRCs equal the JAX node's over the same
    bytes (values, or int8 codes then fp32 scales); a flipped byte fails
    typed, and a good block promotes back."""
    import ml_dtypes
    keys = block_keys(np.arange(8, dtype=np.int32), 2, 4)
    g = torch.Generator().manual_seed(0)
    if dtype == "int8":
        k = torch.randint(-127, 128, (2, 4, 2, 8), generator=g,
                          dtype=torch.int8)
        ks = torch.rand((2, 4, 2), generator=g)
        jk, jks = k.numpy(), ks.numpy()
    else:
        k = torch.randn((2, 4, 2, 8), generator=g).to(dtype)
        ks = None
        jk = k.view(torch.int16).numpy().view(ml_dtypes.bfloat16) \
            if dtype == torch.bfloat16 else k.numpy()
        jks = None
    out = []
    for mod, kk, ss in ((jpc, jk, jks), (None, k, ks)):
        cache = PrefixCache(4, PrefixCacheConfig(1 << 20)) if mod is None \
            else mod.PrefixCache(4, mod.PrefixCacheConfig(1 << 20))
        cache.insert(keys, [3, 4])
        node = cache.evictable(lambda p: 1)
        cache.evict(node, kk, kk, ss, ss)
        node.verify()
        out.append((node.crc_k, node.crc_v, node.host_nbytes,
                    cache.host_bytes))
    assert out[0] == out[1]
    node.k_bytes.view(torch.uint8).reshape(-1)[1] ^= 0x10
    with pytest.raises(SpillCorruptError, match="CRC"):
        node.verify()
    cache.drop_host(node)
    assert cache.stats["restore_failures"] == 1
    assert cache.offloaded_blocks == 0 and cache.host_bytes == 0
    n2 = cache.evictable(lambda p: 1)
    cache.evict(n2, k.clone(), k.clone(), ks, ks)
    n2.verify()
    cache.promote(n2, 9)
    assert cache.walk(keys[:1]) == ([9], [])
    assert cache.stats["restores"] == 1 and cache.host_bytes == 0


def test_offload_config_rejects_negative_budget():
    with pytest.raises(ValueError):
        PrefixCacheConfig(offload_capacity_bytes=-1)
    assert not PrefixCache(4).wants_offload


# ---------------------------------------------------------------------
# engine paths of tests/test_serving_engine.py, on the port
# ---------------------------------------------------------------------
def test_prefix_cache_reuses_and_preserves_output(model):
    _, _, np_tree = model
    prefix = _prompt(16)
    p1, p2 = _prompt(5, prefix), _prompt(3, prefix)
    eng = _engine(np_tree, max_batch=1)
    a = eng.add_request(p1, 4)
    res = eng.run_to_completion()
    assert eng.stats["prefix_blocks_registered"] >= 2
    b = eng.add_request(p2, 4)
    res.update(eng.run_to_completion())
    assert eng.stats["prefix_blocks_reused"] >= 2
    assert eng.prefix_stats()["prefill_tokens_computed"] == 21 + 3
    for rid, p in ((a, p1), (b, p2)):
        np.testing.assert_array_equal(res[rid], _cold(np_tree, p, 4))
    _assert_pool_consistent(eng)


def test_suffix_fill_logits_match_dense_prefill(model):
    """The unbucketed suffix fill over cached pages gives the dense
    tier's first-token logits (the same prompt, cold)."""
    _, _, np_tree = model
    prompt = _prompt(20)
    eng = _engine(np_tree, max_batch=1)
    eng.add_request(prompt, 2)
    eng.run_to_completion()
    dense = eng.last_prefill_logits
    eng.add_request(prompt, 2)
    eng.step()
    assert eng.stats["prefix_blocks_reused"] >= 2
    np.testing.assert_allclose(eng.last_prefill_logits, dense, rtol=1e-4,
                               atol=1e-4)


def test_dense_tier_matches_bucketed_tier(model):
    """A cold prompt through the dense tier (``prefill_buckets=None``)
    against the bucketed chunk fills: first-token logits within 1e-5,
    the same pool pages, the same tokens."""
    _, _, np_tree = model
    prompt = _prompt(37)
    engs = [_engine(np_tree, max_batch=1, prefill_buckets=b)
            for b in (None, (16,))]
    outs = []
    for e in engs:
        rid = e.add_request(prompt, 1)
        outs.append(e.run_to_completion()[rid])
    np.testing.assert_allclose(engs[0].last_prefill_logits,
                               engs[1].last_prefill_logits, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(outs[0], outs[1])
    pages = list(engs[0].prefix_index.values())
    assert pages == list(engs[1].prefix_index.values())
    torch.testing.assert_close(engs[0].pool_k[:, pages],
                               engs[1].pool_k[:, pages], rtol=1e-5,
                               atol=1e-5)


def test_prefix_index_evicts_under_pressure(model):
    _, _, np_tree = model
    eng = _engine(np_tree, max_batch=1, num_blocks=6)
    outs = {}
    for _ in range(4):
        rid = eng.add_request(_prompt(16), 3)
        outs.update(eng.run_to_completion())
        assert rid in outs
        _assert_pool_consistent(eng)
    assert eng.prefix_stats()["evictions"] >= 1


def _offloaded_engine(np_tree, A):
    eng = _engine(np_tree, max_batch=1, prefix_cache_config=PrefixCacheConfig(
        offload_capacity_bytes=1 << 24))
    a = eng.add_request(A, 4)
    res = eng.run_to_completion()
    stolen = eng.alloc.acquire(eng.alloc.free_blocks)
    try:
        b = eng.add_request(_prompt(9), 4)      # evicts -> offloads
        res.update(eng.run_to_completion())
    finally:
        eng.alloc.release(stolen)
    assert b in res
    ps = eng.prefix_stats()
    assert ps["evictions"] >= 2 and ps["offloads"] >= 2, ps
    assert ps["offloaded_bytes"] == eng.prefix_cache.host_bytes > 0
    return eng, res[a]


def test_offload_restore_bit_identical_leak_free(model):
    _, _, np_tree = model
    A = _prompt(21)
    want = _cold(np_tree, A, 4)
    eng, first = _offloaded_engine(np_tree, A)
    c = eng.add_request(A, 4)                   # restores by bytes
    res = eng.run_to_completion()
    assert eng.prefix_stats()["restores"] >= 2
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(res[c], want)
    _assert_pool_consistent(eng)


def test_offload_bitrot_falls_back_to_recompute(model):
    _, _, np_tree = model
    A = _prompt(21)
    want = _cold(np_tree, A, 4)
    eng, _ = _offloaded_engine(np_tree, A)
    for node in eng.prefix_cache._host_lru.values():
        node.k_bytes.view(torch.uint8).reshape(-1)[:2] ^= 0xAD
    c = eng.add_request(A, 4)
    res = eng.run_to_completion()
    ps = eng.prefix_stats()
    assert ps["restore_failures"] >= 1 and ps["restores"] == 0, ps
    np.testing.assert_array_equal(res[c], want)
    _assert_pool_consistent(eng)


def test_shared_page_bytes_unchanged_while_two_slots_decode(model):
    """Two slots decode over the same cached prefix pages: the shared
    pages' bytes never change, and each slot writes only its own pages
    from its prompt's end."""
    _, _, np_tree = model
    prefix = _prompt(16)
    eng = _engine(np_tree)
    eng.add_request(_prompt(2, prefix), 2)
    eng.run_to_completion()
    shared = list(eng.prefix_index.values())
    before = eng.pool_k[:, shared].clone(), eng.pool_v[:, shared].clone()
    a = eng.add_request(_prompt(3, prefix), 10)
    b = eng.add_request(_prompt(6, prefix), 10)
    eng.step()
    assert all(s is not None for s in eng.slots)
    assert all(eng.slot_pages[s][:2] == shared for s in range(2))
    assert all(eng.alloc.ref[p] == 3 for p in shared)
    res = {}
    while eng.active_requests:
        res.update(eng.step())
        assert torch.equal(eng.pool_k[:, shared], before[0])
        assert torch.equal(eng.pool_v[:, shared], before[1])
    res.update(eng.run_to_completion())
    for rid, p in ((a, res[a][:19]), (b, res[b][:22])):
        np.testing.assert_array_equal(res[rid], _cold(np_tree, p, 10))
    _assert_pool_consistent(eng)


def test_cancel_accounting_queued_phase(model):
    _, _, np_tree = model
    prefix = _prompt(16)
    p1, p2 = _prompt(3, prefix), _prompt(5, prefix)
    eng = _engine(np_tree, max_batch=1, num_blocks=8)
    a = eng.add_request(p1, 8)
    b = eng.add_request(p2, 8)
    eng.step()
    free_before, refs_before = eng.alloc.free_blocks, dict(eng.alloc.ref)
    assert eng.cancel(b)
    assert eng.alloc.free_blocks == free_before
    assert eng.alloc.ref == refs_before
    _assert_pool_consistent(eng)
    out = eng.run_to_completion()
    assert a in out and b not in out
    _assert_pool_consistent(eng)


def test_cancel_accounting_scheduled_phase_prefix_shared(model):
    _, _, np_tree = model
    prefix = _prompt(16)
    p1, p2 = _prompt(3, prefix), _prompt(5, prefix)
    eng = _engine(np_tree, num_blocks=16)
    eng.add_request(p1, 6)
    eng.run_to_completion()
    _assert_pool_consistent(eng)
    b = eng.add_request(p2, 6)
    eng.step()
    assert eng.stats["prefix_blocks_reused"] >= 2
    shared = list(eng.prefix_index.values())
    assert any(r >= 2 for p, r in eng.alloc.ref.items() if p in shared)
    assert eng.cancel(b)
    _assert_pool_consistent(eng)
    for p in shared:
        assert eng.alloc.ref.get(p) == 1, eng.alloc.ref
    c = eng.add_request(p2, 6)
    out = eng.run_to_completion()
    np.testing.assert_array_equal(out[c], _cold(np_tree, p2, 6))
    _assert_pool_consistent(eng)


def test_refpool_double_free_and_stale_share_raise():
    pool = _RefPool(4)
    got = pool.acquire(2)
    pool.share(got[:1])
    pool.release(got)
    assert pool.free_blocks == 3 and pool.ref == {got[0]: 1}
    pool.release(got[:1])
    with pytest.raises(RuntimeError, match="double free"):
        pool.release(got)
    with pytest.raises(RuntimeError, match="no live reference"):
        pool.share(got)
    assert pool.free_blocks == 4
    assert pool.acquire(4) is not None


@pytest.mark.parametrize("shared_prefix", [False, True])
def test_prefill_crash_releases_pages_exactly_once(model, shared_prefix):
    """A crash inside the prefill, after the pages are mapped: each
    reference the slot took is released once (the index keeps its own),
    the request keeps waiting, and a retry serves the cold tokens."""
    _, _, np_tree = model
    prefix = _prompt(16)
    p = _prompt(4, prefix)
    eng = _engine(np_tree, num_blocks=16)
    if shared_prefix:
        eng.add_request(_prompt(3, prefix), 6)
        eng.run_to_completion()
    shared = list(eng.prefix_index.values())
    free_before = eng.alloc.free_blocks
    a = eng.add_request(p, 6)
    with faults.crash_mid_prefill(eng) as stats:
        with pytest.raises(faults.InjectedEngineCrash):
            eng.step()
    assert stats["crashed"] == 1
    assert eng.alloc.free_blocks == free_before
    for pg in shared:
        assert eng.alloc.ref.get(pg) == 1
    _assert_pool_consistent(eng)
    assert eng.queue and eng.queue[0].req_id == a
    res = eng.run_to_completion()
    np.testing.assert_array_equal(res[a], _cold(np_tree, p, 6))
    _assert_pool_consistent(eng)


def test_cancel_queued_and_active(model):
    _, _, np_tree = model
    p = _prompt(8)
    eng = _engine(np_tree, max_batch=1, num_blocks=16)
    a = eng.add_request(p, 6)
    b = eng.add_request(p, 6)
    eng.step()
    assert eng.cancel(b) and eng.cancel(a) and not eng.cancel(a)
    assert eng.alloc.free_blocks + len(eng.prefix_index) >= 14
    c = eng.add_request(p, 3)
    out = eng.run_to_completion()
    assert c in out and a not in out and b not in out
    assert eng.batch_occupancy() == 0.0
    assert eng.kv_utilization() == len(eng.prefix_index) / 16
