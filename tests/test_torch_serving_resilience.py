"""Priority preemption with the KV spill tier on the port's engine
(``paddle_tpu_torch/serving/resilience.py``), mirroring the preemption
part of ``tests/test_serving_resilience.py`` on ``llama_tiny``.

A preempt / spill / restore cycle, and a replay from the committed
tokens when the bounded tier dropped the snapshot, give the tokens of an
unpreempted run (greedy and seeded-sampled) and leak no page.  The
snapshot holds exactly the pool's bytes of the committed pages, its
CRCs are the JAX snapshot's over the same bytes, a flipped byte fails
typed, and an int8-KV snapshot and a full-width one are refused by the
other kind of pool.  The engine's preemption counters and tokens equal
the JAX engine's on the same traffic."""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import faults

from paddle_tpu import parallel as dist
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel.topology import HybridTopology, set_topology
from paddle_tpu.quantization import ServeQuantConfig as JQuant
from paddle_tpu.serving.resilience import KVSnapshot as JSnapshot
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.quantization import ServeQuantConfig
from paddle_tpu_torch.serving import (KVSnapshot, SpillCorruptError,
                                      SpillTier, restore_into_slot,
                                      snapshot_slot)

rng = np.random.default_rng(7)


@pytest.fixture(scope="module")
def model():
    cfg = jllama.llama_tiny()
    topo = dist.init_topology(devices=jax.devices()[:1])
    _, init_fn = jllama.build_llama_train_step(cfg, topo,
                                               num_microbatches=1)
    params = init_fn(0)["params"]
    set_topology(HybridTopology())
    return cfg, params, jax.tree_util.tree_map(np.asarray, params)


def _engine(model, dtype="float32", kv_int8=False, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("prefill_buckets", (8,))
    if kv_int8:
        kw["quant_config"] = ServeQuantConfig(kv_dtype="int8")
    return ContinuousBatchingEngine(
        tllama.llama_tiny(dtype=dtype),
        params_from_numpy(model[2], dtype, "cpu"), device="cpu", **kw)


def _prompt(n):
    return rng.integers(0, 256, (n,)).astype(np.int32)


def _solo_result(model, prompt, max_new, **kw):
    """The request alone on a roomy engine: the anchor every resilience
    path is compared with."""
    eng = _engine(model, max_batch=1)
    rid = eng.add_request(prompt, max_new, **kw)
    return eng.run_to_completion()[rid]


def _assert_no_leaks(eng):
    rep = eng.kv_leak_report()
    assert rep["leaked"] == 0 and rep["unaccounted"] == 0, rep


def _preempted_engine(model, p_lo, p_hi, lo_kw=None, **kw):
    """A 1-slot engine whose low-priority request is preempted by a
    high-priority arrival after two steps; returns (engine, lo, hi)."""
    kw.setdefault("max_batch", 1)
    kw.setdefault("num_blocks", 4)
    eng = _engine(model, **kw)
    a = eng.add_request(p_lo, 10, priority=0, **(lo_kw or {}))
    eng.step()
    eng.step()
    b = eng.add_request(p_hi, 8, priority=5)
    return eng, a, b


# ---------------------------------------------------------------------
# preemption: spill and restore
# ---------------------------------------------------------------------
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy",
                                                         "sampled"])
def test_preempt_restore_bit_identity(model, sampled):
    p_lo, p_hi = _prompt(9), _prompt(10)
    kw = dict(temperature=0.8, top_k=8, seed=42) if sampled else {}
    want_lo = _solo_result(model, p_lo, 10, **kw)
    want_hi = _solo_result(model, p_hi, 8)
    eng, a, b = _preempted_engine(model, p_lo, p_hi, kw)
    res = eng.run_to_completion()
    stats = eng.resilience_stats()
    assert stats["preemptions"] >= 1 and stats["restores"] >= 1, stats
    assert stats["spilled_requests"] == 0 and stats["spilled_bytes"] == 0
    assert stats["spill_save_secs"] > 0 and stats["spill_restore_secs"] > 0
    np.testing.assert_array_equal(res[a], want_lo)
    np.testing.assert_array_equal(res[b], want_hi)
    _assert_no_leaks(eng)


def test_preemption_under_kv_pressure(model):
    """Page saturation, not slot saturation: the pool is exhausted, so
    the high-priority arrival admits only by preempting the tenant."""
    p_lo, p_hi = _prompt(9), _prompt(10)
    want_lo = _solo_result(model, p_lo, 10)
    eng = _engine(model, max_batch=2, num_blocks=8,
                  enable_prefix_caching=False)
    a = eng.add_request(p_lo, 10, priority=0)
    eng.step()
    with faults.exhaust_kv_pool(eng) as stats:
        assert stats["stolen"] > 0
        b = eng.add_request(p_hi, 8, priority=5)
        eng.step()
        assert eng.resilience_stats()["preemptions"] >= 1
    res = eng.run_to_completion()
    np.testing.assert_array_equal(res[a], want_lo)
    assert b in res
    _assert_no_leaks(eng)


def test_prefix_shared_waiter_admits_without_preemption(model):
    base = _prompt(16)
    p_x = np.concatenate([base, _prompt(2)])
    p_y = _prompt(9)
    p_h = np.concatenate([base, _prompt(4)])
    want_x = _solo_result(model, p_x, 6)
    want_h = _solo_result(model, p_h, 4)
    eng = _engine(model, max_batch=3, num_blocks=6)
    x = eng.add_request(p_x, 6, priority=0)
    y = eng.add_request(p_y, 7, priority=0)
    eng.step()
    assert eng.alloc.free_blocks == 1
    h = eng.add_request(p_h, 4, priority=5)
    eng.step()
    assert eng.resilience_stats()["preemptions"] == 0
    assert any(s is not None and s.req_id == h for s in eng.slots)
    res = eng.run_to_completion()
    np.testing.assert_array_equal(res[x], want_x)
    np.testing.assert_array_equal(res[h], want_h)
    assert y in res
    _assert_no_leaks(eng)


def test_uniform_priority_never_preempts(model):
    eng = _engine(model, max_batch=1, num_blocks=4)
    a = eng.add_request(_prompt(9), 8)
    b = eng.add_request(_prompt(10), 8)
    res = eng.run_to_completion()
    assert eng.resilience_stats()["preemptions"] == 0
    assert a in res and b in res
    _assert_no_leaks(eng)


def test_priority_admission_order(model):
    eng = _engine(model, max_batch=1, enable_preemption=False)
    a = eng.add_request(_prompt(8), 4, priority=0)
    eng.step()
    b = eng.add_request(_prompt(8), 4, priority=0)
    c = eng.add_request(_prompt(8), 4, priority=9)
    order, seen = [], set()
    while eng.queue or eng.active_requests:
        eng.step()
        for s in eng.slots:
            if s is not None and s.req_id not in seen:
                seen.add(s.req_id)
                order.append(s.req_id)
    assert order.index(c) < order.index(b), (order, (a, b, c))


def test_spill_crc_corruption_is_typed(model):
    """A flipped byte in a spilled snapshot: the restore raises
    SpillCorruptError, the request is dropped, its pages are released
    exactly once, and the engine goes on serving."""
    eng, a, b = _preempted_engine(model, _prompt(9), _prompt(10))
    eng.step()                          # preempts a, admits b
    assert a in eng._spill
    snap = eng._spill[a]
    bad = snap.k_pages.clone()
    bad.view(torch.uint8).reshape(-1)[3] ^= 0xFF
    snap.k_pages = bad
    with pytest.raises(SpillCorruptError):
        eng.run_to_completion()
    assert a not in eng._spill
    assert all(r.req_id != a for r in eng.queue)
    res = eng.run_to_completion()
    assert b in res
    _assert_no_leaks(eng)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8_kv"])
def test_snapshot_holds_the_pool_bytes_with_the_jax_crc(model, kind):
    """The snapshot is the pool's committed pages, byte for byte, and its
    CRCs are the JAX KVSnapshot's over the same bytes (codes then
    scales for an int8 pool); the restore writes them back exactly."""
    dtype = "bfloat16" if kind == "bf16" else "float32"
    eng = _engine(model, dtype, kv_int8=kind == "int8_kv", max_batch=1,
                  num_blocks=8)
    rid = eng.add_request(_prompt(9), 4)
    eng.step()
    snap = snapshot_slot(eng, 0)
    snap.verify()
    assert snap.req_id == rid and snap.length == 10
    assert snap.next_token == eng.tokens[0]
    used = snap.k_pages.shape[1]
    assert used == 2 and snap.num_blocks == len(eng.slot_pages[0])
    pages = eng.slot_pages[0][:used]
    data = eng.pool_k.data if kind == "int8_kv" else eng.pool_k
    assert torch.equal(snap.k_pages, data[:, pages])
    if kind == "int8_kv":
        assert torch.equal(snap.k_scale, eng.pool_k.scale[:, pages])

    def np_(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    j = JSnapshot(snap.req_id, snap.length, snap.next_token,
                  snap.num_blocks, np_(snap.k_pages), np_(snap.v_pages),
                  np_(snap.k_scale), np_(snap.v_scale))
    assert (j.crc_k, j.crc_v, j.nbytes) == (snap.crc_k, snap.crc_v,
                                             snap.nbytes)
    # the restore writes the bytes into other pages, exactly
    eng.slot_pages[0] = eng.alloc.acquire(2) + eng.slot_pages[0][2:]
    restore_into_slot(eng, 0, snap)
    data = eng.pool_k.data if kind == "int8_kv" else eng.pool_k
    assert torch.equal(data[:, eng.slot_pages[0][:2]], snap.k_pages)


@pytest.mark.parametrize("snap_int8", [True, False],
                         ids=["int8_into_bf16", "bf16_into_int8"])
def test_snapshot_of_other_quantization_is_refused(model, snap_int8):
    src = _engine(model, "bfloat16", kv_int8=snap_int8, max_batch=1)
    dst = _engine(model, "bfloat16", kv_int8=not snap_int8, max_batch=1)
    rid = src.add_request(_prompt(9), 4)
    src.step()
    snap = snapshot_slot(src, 0)
    assert src.spill_compatible(snap) and not dst.spill_compatible(snap)
    with pytest.raises(ValueError, match="geometry"):
        dst.adopt_preempted(src.slots[0], snap)
    dst.slot_pages[0] = dst.alloc.acquire(snap.num_blocks)
    with pytest.raises(SpillCorruptError, match="quantiz"):
        restore_into_slot(dst, 0, snap)
    assert rid == 0


def test_adopt_preempted_resumes_on_another_engine(model):
    """A snapshot moved to a second engine of the same geometry restores
    there and finishes with the unpreempted tokens."""
    p = _prompt(9)
    want = _solo_result(model, p, 10)
    src = _engine(model, max_batch=1)
    rid = src.add_request(p, 10)
    src.step()
    src.step()
    src.preempt(0)
    req, snap = src.queue.popleft(), src._spill.pop(rid)
    dst = _engine(model, max_batch=1)
    dst.adopt_preempted(req, snap)
    with pytest.raises(ValueError, match="already spilled"):
        dst.adopt_preempted(req, snap)
    assert dst.spilled_bytes == snap.nbytes
    res = dst.run_to_completion()
    np.testing.assert_array_equal(res[rid], want)
    assert dst.resilience_stats()["restores"] == 1
    _assert_no_leaks(dst)
    _assert_no_leaks(src)


def test_zero_capacity_spill_tier_replays_from_the_prefix(model):
    """``SpillTier(capacity_bytes=0)`` drops every snapshot: the
    preempted request is replayed from its committed tokens and still
    finishes with the unpreempted tokens."""
    p_lo, p_hi = _prompt(9), _prompt(10)
    want_lo = _solo_result(model, p_lo, 10)
    eng, a, b = _preempted_engine(model, p_lo, p_hi,
                                  spill_tier=SpillTier(capacity_bytes=0))
    res = eng.run_to_completion()
    st = eng.resilience_stats()
    assert st["preemptions"] >= 1 and st["spill_evictions"] >= 1
    assert st["prefix_replays"] >= 1 and st["restores"] == 0, st
    np.testing.assert_array_equal(res[a], want_lo)
    assert b in res
    _assert_no_leaks(eng)


def test_spill_tier_bounds_and_evicts_oldest():
    def snap(rid, n):
        k = torch.zeros((1, n, 2, 1, 4))
        return KVSnapshot(rid, 3, 1, n, k, k.clone())
    one = snap(0, 1).nbytes
    tier = SpillTier(capacity_bytes=3 * one)
    assert tier.put(0, snap(0, 1)) == [] and tier.put(1, snap(1, 1)) == []
    assert tier.put(2, snap(2, 2)) == [0]           # 4 > 3: oldest out
    assert list(tier.keys()) == [1, 2] and tier.nbytes == 3 * one
    assert tier.put(3, snap(3, 4)) == [1, 2, 3]     # alone past the cap
    assert len(tier) == 0 and tier.evictions == 4
    with pytest.raises(ValueError):
        SpillTier(capacity_bytes=-1)
    with pytest.raises(ValueError):
        SpillTier(policy="lru")


def test_cancel_of_a_preempted_waiter_drops_its_snapshot(model):
    eng, a, b = _preempted_engine(model, _prompt(9), _prompt(10))
    eng.step()
    assert a in eng._spill and eng.spilled_bytes > 0
    assert eng.cancel(a)
    assert a not in eng._spill and eng.spilled_bytes == 0
    res = eng.run_to_completion()
    assert b in res and a not in res
    _assert_no_leaks(eng)


# ---------------------------------------------------------------------
# the same traffic through the JAX engine
# ---------------------------------------------------------------------
@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8_kv"])
def test_preemption_matches_jax_engine(model, kv_int8):
    cfg, params = model[:2]
    p_lo, p_hi = _prompt(9), _prompt(10)
    jeng = JEngine(cfg, params, max_batch=1, block_size=8, num_blocks=4,
                   prefill_buckets=(8,),
                   quant_config=JQuant(kv_dtype="int8") if kv_int8
                   else None)
    teng = _engine(model, kv_int8=kv_int8, max_batch=1, num_blocks=4)
    out = []
    for eng in (jeng, teng):
        a = eng.add_request(p_lo, 10, priority=0, temperature=0.8,
                            top_k=8, seed=42)
        eng.step()
        eng.step()
        b = eng.add_request(p_hi, 8, priority=5)
        eng.step()
        assert eng.resilience_stats()["spilled_bytes"] > 0
        res = eng.run_to_completion()
        st = {k: v for k, v in eng.resilience_stats().items()
              if not k.endswith("_secs")}
        out.append((res[a].tolist(), res[b].tolist(), st,
                    eng.kv_leak_report()))
    assert out[1] == out[0]
    assert out[0][2]["preemptions"] >= 1 and out[0][2]["restores"] >= 1
