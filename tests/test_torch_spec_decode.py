"""The port's speculative decoding (``paddle_tpu_torch/spec_decode/``, the
engine's ``spec_config``) against the JAX package on ``llama_tiny``, with
the geometry of ``tests/test_spec_decode.py``: ``max_batch=2``,
``block_size=8``, ``num_blocks=64``, ``k=3``, ``window=12``, the engine
defaults otherwise.  Two drafts, both bridged through
``params_from_numpy``: the target itself and an independent init (the
JAX file's ``weak_draft``, which rejects nearly every proposal).

Pinned here: greedy ids equal to the JAX spec engine's and to the port's
own baseline engine's (both drafts, fp32 and bf16), sampled ids equal to
the JAX spec engine's in fp32, ``spec_stats()`` equal to JAX's key for
key, the draft's proposals equal to JAX's ``build_draft_program`` on the
same windows, ``warp_probs`` / ``spec_sample_chain`` / ``_stale_pages``
bit-equal to JAX's, the rejection-sampling identities, cancels and
rollback-heavy runs with zero leaks, the ``enabled=False`` knob, the
validation errors, quantization, prefix caching and preemption under
speculation, and a request whose verify writes run past the table's
end.

Not ported, so not here: the JAX file's ``ServingFrontend`` stream case
(its frontend is ROADMAP.md queue 1 item 13; the engine-level stream is
pinned instead), the serve telemetry registry case (item 13) and the two
AOT warm-start cases (item 16)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import parallel as dist
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel.topology import HybridTopology, set_topology
from paddle_tpu.quantization import ServeQuantConfig as JQuant
from paddle_tpu.spec_decode import SpecDecodeConfig as JSpec
from paddle_tpu.spec_decode import draft as jdraft
from paddle_tpu.spec_decode import sampling as jsampling
from paddle_tpu.spec_decode.runner import SpecDecodeRunner as JRunner
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.quantization import ServeQuantConfig
from paddle_tpu_torch.spec_decode import (SpecDecodeConfig, SpecDecodeRunner,
                                          build_draft_program,
                                          spec_sample_chain, warp_probs)
from paddle_tpu_torch.spec_decode.draft import assemble_windows
from paddle_tpu_torch.spec_decode.sampling import position_rng

GEOM = dict(max_batch=2, block_size=8, num_blocks=64)
K, W = 3, 12
PROMPT_LENS = (5, 9, 3)
NEW = 6
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (temperature, top_k, top_p, seed) of the sampled requests
SAMPLED = [(0.8, 20, None, 7), (1.0, None, 0.9, 8), (0.7, 5, 0.8, 9)]


def _init(dtype):
    cfg = jllama.llama_tiny(dtype=dtype)
    topo = dist.init_topology(devices=jax.devices()[:1])
    _, init_fn = jllama.build_llama_train_step(cfg, topo,
                                               num_microbatches=1)
    params = init_fn(0)["params"]
    _, init2 = jllama.build_llama_train_step(cfg, topo, num_microbatches=1)
    weak = init2(1)["params"]
    set_topology(HybridTopology())
    tcfg = tllama.llama_tiny(dtype=dtype)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                           dtype, "cpu")
    tw = params_from_numpy(jax.tree_util.tree_map(np.asarray, weak), dtype,
                           "cpu")
    return dict(dtype=dtype, jcfg=cfg, jp=params, jw=weak, tcfg=tcfg,
                tp=tp, tw=tw)


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = _init(dtype)
        return cache[dtype]
    return get


def _jspec(m, self_draft=True, **kw):
    kw.setdefault("k", K)
    kw.setdefault("window", W)
    return JSpec(draft_cfg=m["jcfg"],
                 draft_params=m["jp"] if self_draft else m["jw"], **kw)


def _tspec(m, self_draft=True, **kw):
    kw.setdefault("k", K)
    kw.setdefault("window", W)
    return SpecDecodeConfig(draft_cfg=m["tcfg"],
                            draft_params=m["tp"] if self_draft else m["tw"],
                            **kw)


def _jengine(m, spec=None, **kw):
    kw = {**GEOM, **kw}
    if "quant" in kw:
        kw["quant_config"] = JQuant(**kw.pop("quant"))
    return JEngine(m["jcfg"], m["jp"], spec_config=spec, **kw)


def _tengine(m, spec=None, **kw):
    kw = {**GEOM, **kw}
    if "quant" in kw:
        kw["quant_config"] = ServeQuantConfig(**kw.pop("quant"))
    return ContinuousBatchingEngine(m["tcfg"], m["tp"], spec_config=spec,
                                    device="cpu", **kw)


def _prompts(ns=PROMPT_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in ns]


def _serve(eng, work):
    """``work``: [(prompt, new tokens, add_request kwargs)]; returns the
    ids in request order."""
    rids = [eng.add_request(p, n, **kw) for p, n, kw in work]
    out = eng.run_to_completion()
    return [out[r] for r in rids]


def _no_leaks(eng):
    rep = eng.kv_leak_report()
    assert rep["leaked"] == 0 and rep["unaccounted"] == 0, rep


def _same_ids(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------
# the engine against the JAX spec engine and the port's baseline
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("self_draft", [True, False],
                         ids=["self_draft", "weak_draft"])
def test_greedy_ids_match_jax_spec_and_port_baseline(models, dtype,
                                                     self_draft):
    m = models(dtype)
    work = [(p, NEW, {}) for p in _prompts()]
    jeng = _jengine(m, _jspec(m, self_draft))
    want = _serve(jeng, work)
    teng = _tengine(m, _tspec(m, self_draft))
    got = _serve(teng, work)
    base = _serve(_tengine(m), work)
    _same_ids(got, want)
    _same_ids(got, base)
    stats = teng.spec_stats()
    assert stats["spec_steps"] > 0
    if self_draft:
        assert stats["acceptance_rate"] > 0.0
        assert stats["engine_steps_per_token"] < 1.0
    else:
        assert stats["engine_steps_per_token"] == 1.0
    if dtype == "float32":
        assert stats == jeng.spec_stats()
    _no_leaks(teng)


def test_sampled_ids_and_stats_match_jax_spec(models):
    """fp32: the sampled requests' rejection chains run on the verify's
    logits (1e-4 from JAX's), with the same Philox draws."""
    m = models("float32")
    prompts = _prompts((6, 9, 4, 7), seed=1)
    work = [(p, 8, dict(temperature=t, top_k=k, top_p=tp, seed=s))
            for p, (t, k, tp, s) in zip(prompts, SAMPLED)]
    work.append((prompts[-1], 5, {}))
    jeng = _jengine(m, _jspec(m))
    teng = _tengine(m, _tspec(m))
    _same_ids(_serve(teng, work), _serve(jeng, work))
    assert teng.spec_stats() == jeng.spec_stats()
    assert teng.spec_stats()["accepted"] > 0
    _no_leaks(teng)


def test_verify_logits_match_jax_step_by_step(models):
    """Every spec step's ``last_logits`` (the verify's column 0) within
    1e-4 of the JAX engine's, with the same slots live."""
    m = models("float32")
    jeng, teng = _jengine(m, _jspec(m)), _tengine(m, _tspec(m))
    for p in _prompts():
        assert jeng.add_request(p, NEW) == teng.add_request(p, NEW)
    while jeng.queue or any(s is not None for s in jeng.slots):
        jeng.step()
        teng.step()
        assert (jeng.last_logits is None) == (teng.last_logits is None)
        if jeng.last_logits is not None:
            live = [s for s in range(jeng.B) if jeng.slots[s] is not None]
            np.testing.assert_allclose(teng.last_logits[live],
                                       jeng.last_logits[live],
                                       rtol=TOL["float32"],
                                       atol=TOL["float32"])
            assert [s and s.out for s in teng.slots] == \
                [s and s.out for s in jeng.slots]
    assert teng.spec_stats() == jeng.spec_stats()


# ---------------------------------------------------------------------
# the draft against JAX's build_draft_program
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_draft_proposals_match_jax(models, dtype):
    """Windows with an inactive row, a short row (left padding), a row
    longer than the window (left-truncated, rotated by absolute position)
    and one ending at max_position_embeddings."""
    m = models(dtype)
    rng = np.random.default_rng(2)
    lens = (0, 4, 40, m["jcfg"].max_position_embeddings, 12, 1)
    seqs = [rng.integers(0, 256, n).tolist() for n in lens]
    win, ctx = assemble_windows(seqs, W, len(seqs))
    jwin, jctx = jdraft.assemble_windows(seqs, W, len(seqs))
    np.testing.assert_array_equal(win, jwin)
    np.testing.assert_array_equal(ctx, jctx)
    for self_draft in (True, False):
        jparams, tparams = (m["jp"], m["tp"]) if self_draft else \
            (m["jw"], m["tw"])
        want = np.asarray(jax.jit(jdraft.build_draft_program(
            m["jcfg"], W))(jparams, jnp.asarray(win), jnp.asarray(ctx)))
        draft = build_draft_program(m["tcfg"], W, "cpu")
        got = draft(tparams, torch.from_numpy(win),
                    torch.from_numpy(ctx)).numpy()
        live = ctx > 0
        if dtype == "float32":
            np.testing.assert_array_equal(got[live], want[live])
            continue
        # bf16: where the ids differ, JAX's id is a near tie on the
        # port's logits
        logits = draft.logits(tparams, torch.from_numpy(win),
                              torch.from_numpy(ctx)).numpy()
        for b in np.nonzero(live & (got != want))[0]:
            top = logits[b].max()
            assert top - logits[b, want[b]] <= TOL[dtype] * (1 + abs(top))
        assert (got[live] == want[live]).mean() >= 0.8


# ---------------------------------------------------------------------
# the host-side numpy pieces: bit-equal to JAX's
# ---------------------------------------------------------------------
@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(1.0, None, None), (0.7, 5, None),
                          (1.3, None, 0.9), (0.8, 20, 0.5), (1.0, 200, 0.99),
                          (0.5, 1, None)])
def test_warp_probs_bit_equal_to_jax(temperature, top_k, top_p):
    rng = np.random.default_rng(3)
    for _ in range(4):
        logits = (rng.standard_normal(256) * 3).astype(np.float32)
        got = warp_probs(logits, temperature, top_k, top_p)
        want = jsampling.warp_probs(logits, temperature, top_k, top_p)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_q", [False, True], ids=["one_hot", "full_q"])
def test_spec_sample_chain_bit_equal_to_jax(with_q):
    rng = np.random.default_rng(4)
    for trial in range(40):
        k = 1 + trial % 4
        p = [rng.dirichlet(np.full(16, 0.3)) for _ in range(k + 1)]
        q = [rng.dirichlet(np.full(16, 0.3)) for _ in range(k)] \
            if with_q else None
        props = [int(rng.integers(0, 16)) if trial % 3 else
                 int(np.argmax(p[i])) for i in range(k)]
        kw = dict(seed=trial, start_position=5 * trial)
        assert spec_sample_chain(p, props, q, **kw) == \
            jsampling.spec_sample_chain(p, props, q, **kw)
    with pytest.raises(ValueError, match="K\\+1"):
        spec_sample_chain([p[0]], [1, 2])


def test_position_rng_and_stale_pages_match_jax():
    for seed, pos in [(0, 0), (7, 11), (2 ** 31 + 5, 3), (3, 2 ** 32 - 1)]:
        assert position_rng(seed, pos).random() == \
            jsampling.position_rng(seed, pos).random()
    for c in range(0, 20):
        for w in range(0, 24):
            for bs in (1, 4, 8):
                assert SpecDecodeRunner._stale_pages(c, w, bs) == \
                    JRunner._stale_pages(c, w, bs)


# the rejection-sampling identity cases of tests/test_spec_decode.py,
# on the port's functions
def test_rejection_sampling_identity_one_hot_draft():
    p = np.array([0.5, 0.25, 0.125, 0.0625, 0.0625])
    proposal = 3
    counts = np.zeros(5)
    n = 20000
    for seed in range(n):
        emitted, _ = spec_sample_chain([p, p], [proposal], seed=seed,
                                       start_position=11)
        counts[emitted[0]] += 1
    tv = 0.5 * np.abs(counts / n - p).sum()
    assert tv < 0.02, (tv, counts / n)


def test_rejection_sampling_identity_full_q():
    p = np.array([0.1, 0.6, 0.1, 0.2])
    q = np.array([0.7, 0.1, 0.1, 0.1])
    counts = np.zeros(4)
    n = 20000
    for seed in range(n):
        x = int(position_rng(seed, 0).choice(4, p=q))
        emitted, _ = spec_sample_chain([p, p], [x], q_dists=[q],
                                       seed=seed, start_position=5)
        counts[emitted[0]] += 1
    tv = 0.5 * np.abs(counts / n - p).sum()
    assert tv < 0.02, (tv, counts / n)


def test_chain_acceptance_and_bonus_semantics():
    sure = np.array([0.0, 1.0, 0.0])
    emitted, accepted = spec_sample_chain([sure, sure], [1], seed=3)
    assert accepted == 1 and emitted == [1, 1]
    p = np.array([0.5, 0.0, 0.5])
    for seed in range(32):
        emitted, accepted = spec_sample_chain([p, p], [1], seed=seed)
        assert accepted == 0 and len(emitted) == 1
        assert emitted[0] in (0, 2)


def test_warp_probs_matches_sampler_semantics():
    logits = np.full((32,), -10.0, np.float32)
    logits[5], logits[9] = 4.0, 3.9
    p = warp_probs(logits, 1.0, 2, None)
    assert set(np.nonzero(p)[0]) == {5, 9}
    np.testing.assert_allclose(p.sum(), 1.0, rtol=1e-12)
    logits = np.zeros((32,), np.float32)
    logits[5], logits[9] = 8.0, 4.0
    p = warp_probs(logits, 1.0, 2, 0.95)
    assert set(np.nonzero(p)[0]) == {5}
    p = warp_probs(np.array([0.0, np.log(3.0)]), 1.0, None, None)
    np.testing.assert_allclose(p, [0.25, 0.75], atol=1e-12)


# ---------------------------------------------------------------------
# rollback and pool accounting
# ---------------------------------------------------------------------
def test_cancel_mid_speculation_no_leak(models):
    m = models("float32")
    prompts = _prompts((5, 9))
    want = _serve(_tengine(m, max_batch=1), [(prompts[1], 8, {})])[0]
    eng = _tengine(m, _tspec(m))
    a = eng.add_request(prompts[0], 40)
    b = eng.add_request(prompts[1], 8)
    eng.step()
    eng.step()
    assert eng.spec_stats()["spec_steps"] >= 1
    assert eng.cancel(a)
    _no_leaks(eng)
    out = eng.run_to_completion()
    np.testing.assert_array_equal(out[b], want)
    _no_leaks(eng)
    assert eng.alloc.free_blocks + len(eng.prefix_index) \
        == eng.alloc.num_blocks


def _drive(eng, plan):
    """``plan``: {step: [("add", prompt, n, kw) | ("cancel", index)]};
    returns {request index: ids} of the finished requests."""
    rids, done = [], {}
    step = 0
    while step <= max(plan) or eng.queue or \
            any(s is not None for s in eng.slots):
        for op in plan.get(step, ()):
            if op[0] == "add":
                rids.append(eng.add_request(op[1], op[2], **op[3]))
            else:
                eng.cancel(rids[op[1]])
        done.update(eng.step())
        step += 1
    return {rids.index(r): ids for r, ids in done.items()}


def test_rollback_heavy_run_with_cancels_matches_jax(models):
    """The weak draft rejects nearly everything — every step is
    rollback-heavy — while requests (a quarter sampled) arrive and are
    cancelled mid-stream; the same schedule through the JAX spec engine
    gives the same ids and stats, and the pool drains clean."""
    m = models("float32")
    rng = np.random.default_rng(5)
    plan = {}
    for i in range(10):
        p = rng.integers(0, 256, int(rng.integers(3, 11))).astype(np.int32)
        kw = dict(temperature=0.9, top_k=30, seed=i) if i % 4 == 1 else {}
        plan.setdefault(i // 2, []).append(("add", p, int(rng.integers(3, 9)),
                                            kw))
    for step, idx in ((3, 1), (4, 4), (6, 7)):
        plan.setdefault(step, []).append(("cancel", idx))
    jeng = _jengine(m, _jspec(m, self_draft=False), num_blocks=48)
    teng = _tengine(m, _tspec(m, self_draft=False), num_blocks=48)
    want, got = _drive(jeng, plan), _drive(teng, plan)
    assert sorted(got) == sorted(want) and len(got) < 10
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])
    stats = teng.spec_stats()
    assert stats == jeng.spec_stats()
    assert stats["rollback_pages"] > 0
    _no_leaks(teng)


@pytest.mark.parametrize("mbps", [None, 5], ids=["max_pos", "table_5"])
def test_verify_writes_past_the_table_end(models, mbps):
    """Requests whose ``prompt + max_new_tokens`` ends at, 1 and 2 before
    the table's end (the default table: block_size * max_blocks_per_seq
    = max_position_embeddings; or a table of 5 pages), so the verify of
    their last steps writes up to K positions past it: those writes are
    dropped, the RoPE positions past the table's end clamp, and ids,
    stats and the pool match the JAX spec engine and the baseline."""
    m = models("float32")
    end = (mbps or 16) * GEOM["block_size"]
    prompts = _prompts((end - 10, end - 11, end - 12), seed=6)
    work = [(p, 10, {}) for p in prompts]
    kw = {} if mbps is None else {"max_blocks_per_seq": mbps}
    jeng = _jengine(m, _jspec(m), **kw)
    teng = _tengine(m, _tspec(m), **kw)
    written, verify = [], teng._spec.verify

    def spy(bt, lengths, tokens):
        written.append(int(lengths.max()) + tokens.shape[1])
        return verify(bt, lengths, tokens)
    teng._spec.verify = spy
    got = _serve(teng, work)
    assert max(written) > end
    _same_ids(got, _serve(jeng, work))
    _same_ids(got, _serve(_tengine(m, **kw), work))
    assert teng.spec_stats() == jeng.spec_stats()
    _no_leaks(teng)
    assert teng.kv_leak_report() == jeng.kv_leak_report()


def test_spec_disabled_knob_runs_baseline_path(models):
    m = models("float32")
    work = [(p, 5, {}) for p in _prompts()]
    eng = _tengine(m, _tspec(m, enabled=False))
    _same_ids(_serve(eng, work), _serve(_tengine(m), work))
    stats = eng.spec_stats()
    assert stats["enabled"] is False and stats["spec_steps"] == 0
    assert stats["engine_steps_per_token"] == 1.0
    assert _tengine(m).spec_stats() is None


# ---------------------------------------------------------------------
# speculation with the engine's other features, against JAX
# ---------------------------------------------------------------------
FEATURES = {
    "int8_weights_int8_kv": {"quant": {"weight_dtype": "int8",
                                       "kv_dtype": "int8"}},
    "prefix_hits": {},
    "preemption": {"max_batch": 1},
}


@pytest.mark.parametrize("name", list(FEATURES))
def test_spec_with_engine_features_matches_jax(models, name):
    """Quantized weights and KV (the verify runs the quantized step, the
    draft stays full width); prefix hits on a shared prompt; a
    higher-priority arrival preempting a speculating request.  Ids and
    stats equal the JAX spec engine's; greedy ids equal the port's
    baseline at the same config."""
    m = models("float32")
    kw = dict(FEATURES[name])
    prefix = _prompts((16,), seed=7)[0]
    tails = _prompts((3, 6, 4), seed=8)
    work = [(np.concatenate([prefix, t]), NEW, {}) for t in tails]
    if name == "preemption":
        work = [(work[0][0], 12, {}), (work[1][0], 4, {"priority": 1})]
    jeng, teng = _jengine(m, _jspec(m), **kw), _tengine(m, _tspec(m), **kw)
    if name == "preemption":
        # the preemptor arrives while the first request speculates
        a = [e.add_request(*work[0][:2], **work[0][2]) for e in (jeng, teng)]
        for e in (jeng, teng):
            e.step()
            e.step()
        b = [e.add_request(*work[1][:2], **work[1][2]) for e in (jeng, teng)]
        outs = [e.run_to_completion() for e in (jeng, teng)]
        want = [outs[0][a[0]], outs[0][b[0]]]
        got = [outs[1][a[1]], outs[1][b[1]]]
        assert teng.resilience_stats()["preemptions"] >= 1
    else:
        want, got = _serve(jeng, work), _serve(teng, work)
    _same_ids(got, want)
    assert teng.spec_stats() == jeng.spec_stats()
    if name == "prefix_hits":
        assert teng.prefix_stats()["hits"] >= 1
    if name != "preemption":
        _same_ids(got, _serve(_tengine(m, **kw), work))
    _no_leaks(teng)


# ---------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------
def test_spec_config_validation(models):
    m = models("float32")
    cfg = m["tcfg"]
    bad_vocab = dataclasses.replace(cfg, vocab_size=cfg.vocab_size + 1)
    with pytest.raises(ValueError, match="vocab"):
        _tengine(m, SpecDecodeConfig(draft_cfg=bad_vocab,
                                     draft_params=m["tp"]))
    bad_pos = dataclasses.replace(
        cfg, max_position_embeddings=cfg.max_position_embeddings // 2)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        _tengine(m, SpecDecodeConfig(draft_cfg=bad_pos,
                                     draft_params=m["tp"]))
    with pytest.raises(ValueError, match="k must be"):
        SpecDecodeConfig(draft_cfg=cfg, draft_params=m["tp"], k=0)
    with pytest.raises(ValueError, match="window must be"):
        SpecDecodeConfig(draft_cfg=cfg, draft_params=m["tp"], window=1)
    with pytest.raises(TypeError, match="SpecDecodeConfig"):
        _tengine(m, _jspec(m))
    bf16 = {k: v for k, v in m["tp"].items() if k != "blocks"}
    bf16["wte"] = bf16["wte"].bfloat16()
    bf16["blocks"] = m["tp"]["blocks"]
    with pytest.raises(ValueError, match="wte"):
        _tengine(m, SpecDecodeConfig(draft_cfg=cfg, draft_params=bf16))
    with pytest.raises(ValueError, match="shape"):
        _tengine(m, SpecDecodeConfig(
            draft_cfg=dataclasses.replace(cfg, num_layers=1),
            draft_params=m["tp"]))
    assert SpecDecodeConfig(draft_cfg=cfg, draft_params=m["tp"]).manifest() \
        == {"k": 4, "window": 16, "draft_model": dataclasses.asdict(cfg)}


def test_moe_draft_is_refused(models):
    m = models("float32")
    moe = dataclasses.replace(m["tcfg"], moe_num_experts=4)
    with pytest.raises(NotImplementedError, match="item 15b"):
        _tengine(m, SpecDecodeConfig(draft_cfg=moe, draft_params=m["tp"]))
