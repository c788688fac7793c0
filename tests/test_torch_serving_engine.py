"""The port's continuous-batching engine against the JAX engine on
``llama_tiny`` with bucketed prefill: the same parameters (handed over
through ``bridge.params_from_numpy``) and the same requests must give
IDENTICAL greedy token ids, and the decode logits of every step must
agree to 1e-4 in fp32 (both engines with prefix caching and preemption
off; the defaults are held in tests/test_torch_prefix_cache.py).  Also
pins cancellation and KV accounting, the refusals of features outside
the port's slice (MoE configs and MoE drafts, and dynamic-NTK RoPE; an
``aot_dir`` without an artifact falls back), and the host-side pieces
(RoPE tables, bucket plans, seeded parameters) against the JAX
package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import parallel as dist
from paddle_tpu.aot.buckets import ShapeBucketRegistry as JBuckets
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel.topology import HybridTopology, set_topology
from paddle_tpu_torch.aot.buckets import ShapeBucketRegistry as TBuckets
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.device import make_generator
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.quantization import ServeQuantConfig
from paddle_tpu_torch.spec_decode import SpecDecodeConfig

PROMPT_LENS = (5, 20, 37, 9, 16)
BUDGETS = (6, 4, 8, 5, 3)


@pytest.fixture(scope="module")
def model():
    cfg = jllama.llama_tiny()
    topo = dist.init_topology(devices=jax.devices()[:1])
    _, init_fn = jllama.build_llama_train_step(cfg, topo, num_microbatches=1)
    params = init_fn(0)["params"]
    set_topology(HybridTopology())
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, np_tree


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _torch_engine(np_tree, **kw):
    cfg = tllama.llama_tiny()
    kw.setdefault("max_batch", 2)
    kw.setdefault("prefill_buckets", (16,))
    # as the JAX engine these tests compare with is built
    kw.setdefault("enable_prefix_caching", False)
    kw.setdefault("enable_preemption", False)
    return ContinuousBatchingEngine(
        cfg, params_from_numpy(np_tree, cfg.dtype, "cpu"), device="cpu",
        **kw)


def test_greedy_tokens_identical_to_jax_engine(model):
    cfg, params, np_tree = model
    jeng = JEngine(cfg, params, max_batch=2, prefill_buckets=(16,),
                   enable_prefix_caching=False, enable_preemption=False)
    teng = _torch_engine(np_tree)
    for p, n in zip(_prompts(cfg.vocab_size), BUDGETS):
        assert jeng.add_request(p, n) == teng.add_request(p, n)
    jres, tres, steps = {}, {}, 0
    while jeng.queue or any(s is not None for s in jeng.slots):
        jres.update(jeng.step())
        tres.update(teng.step())
        steps += 1
        if jeng.last_logits is None:
            assert teng.last_logits is None
        else:
            np.testing.assert_allclose(teng.last_logits, jeng.last_logits,
                                       rtol=1e-4, atol=1e-4)
    tres.update(teng.run_to_completion())
    assert steps > len(PROMPT_LENS)
    assert sorted(jres) == sorted(tres) == list(range(len(PROMPT_LENS)))
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], jres[rid])
    assert teng.kv_leak_report()["leaked"] == 0
    jstats = jeng.aot_stats()
    assert {k: jstats[k] for k in teng.bucket_stats()} == teng.bucket_stats()


def test_cancel_queued_and_running_frees_pages(model):
    _, _, np_tree = model
    eng = _torch_engine(np_tree, max_batch=1)
    prompts = _prompts(256)
    a = eng.add_request(prompts[1], 8)
    b = eng.add_request(prompts[2], 8)
    eng.step()                                   # a admitted, b waiting
    assert eng.active_requests == 1 and eng.queue_depth == 1
    assert eng.cancel(b) and eng.queue_depth == 0
    assert eng.cancel(a) and eng.active_requests == 0
    assert not eng.cancel(a)
    rep = eng.kv_leak_report()
    assert rep["leaked"] == 0 and rep["unaccounted"] == 0
    assert rep["free_blocks"] == eng.alloc.num_blocks
    assert eng.run_to_completion() == {}


def test_kv_leak_report_clean_after_drain_with_eos(model):
    _, _, np_tree = model
    eng = _torch_engine(np_tree)
    for p in _prompts(256):
        eng.add_request(p, 4, eos_token_id=int(p[0]))
    res = eng.run_to_completion()
    assert len(res) == len(PROMPT_LENS)
    rep = eng.kv_leak_report()
    assert rep == {"free_blocks": eng.alloc.num_blocks, "index_blocks": 0,
                   "slot_blocks": 0, "leaked": 0, "unaccounted": 0}


@pytest.mark.parametrize("kw", [{"spec_config": "moe_draft"},
                                {"aot_dir": "/nonexistent"}],
                         ids=lambda kw: next(iter(kw)))
def test_features_outside_the_slice_are_refused(model, kw):
    """Of speculative decoding (ported) a MoE draft (item 15b); and an
    ``aot_dir`` that holds no artifact is refused as a warm start, as the
    JAX engine refuses it: a fresh build, the reason on ``aot_error``
    (the warm starts themselves: tests/test_torch_aot.py)."""
    _, _, np_tree = model
    if "aot_dir" in kw:
        eng = _torch_engine(np_tree, **kw)
        assert not eng.aot_loaded
        assert "no AOT manifest" in eng.aot_error
        assert eng.aot_stats()["aot_error"] == eng.aot_error
        return
    if "spec_config" in kw:
        moe = tllama.llama_tiny(moe_num_experts=4)
        kw = {"spec_config": SpecDecodeConfig(
            draft_cfg=moe, draft_params=params_from_numpy(
                np_tree, "float32", "cpu"))}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _torch_engine(np_tree, **kw)


@pytest.mark.parametrize("cfg_kw", [{"moe_num_experts": 4},
                                    {"rope_scaling": {"rope_type": "dynamic",
                                                      "factor": 2.0}}])
def test_moe_and_dynamic_rope_configs_are_refused(model, cfg_kw):
    _, _, np_tree = model
    cfg = tllama.llama_tiny(**cfg_kw)
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(cfg, params_from_numpy(np_tree, "float32",
                                                        "cpu"), device="cpu")


def test_jax_shaped_blocks_are_rejected_with_a_hint(model):
    _, _, np_tree = model
    cfg = tllama.llama_tiny()
    raw = {k: torch.from_numpy(np.array(v)) for k, v in np_tree.items()
           if k != "blocks"}
    raw["blocks"] = {k: torch.from_numpy(np.array(v))
                     for k, v in np_tree["blocks"].items()}
    with pytest.raises(ValueError, match="params_from_numpy"):
        ContinuousBatchingEngine(cfg, raw, device="cpu")


@pytest.mark.parametrize("scaling", [
    None, {"rope_type": "linear", "factor": 2.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 64}],
    ids=["none", "linear", "llama3"])
def test_rope_tables_match_jax(scaling):
    jc, js = jllama._rope_cos_sin(96, 16, 10000.0, jnp.float32, scaling)
    tc, ts = tllama._rope_cos_sin(96, 16, 10000.0, torch.float32, scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 63, 64, 300, 601])
def test_bucket_plans_match_jax(n):
    sizes = (16, 64, 256)
    j, t = JBuckets(sizes), TBuckets(sizes)
    assert t.plan_chunks(n) == j.plan_chunks(n)
    assert t.stats() == j.stats()


def test_init_params_layout_and_seed():
    cfg = tllama.llama_tiny()
    a = tllama.init_params(cfg, make_generator(3, "cpu"), device="cpu")
    b = tllama.init_params(cfg, make_generator(3, "cpu"), device="cpu")
    jshape = jax.eval_shape(lambda: jllama.init_block_params(
        jllama.llama_tiny(), jax.random.key(0)))
    assert set(a["blocks"]) == set(jshape)
    for k, v in jshape.items():
        assert tuple(a["blocks"][k].shape) == (cfg.num_layers,) + v.shape
        torch.testing.assert_close(a["blocks"][k], b["blocks"][k])
    assert tuple(a["wte"].shape) == (cfg.vocab_size, cfg.hidden_size)
    assert tuple(a["head"].shape) == (cfg.hidden_size, cfg.vocab_size)
    assert abs(float(a["wte"].std()) - cfg.initializer_range) < 2e-3
    assert torch.equal(a["blocks"]["ln1_w"], torch.ones_like(
        a["blocks"]["ln1_w"]))
    # the engine serves the seeded tree as it comes
    eng = ContinuousBatchingEngine(cfg, a, prefill_buckets=(16,),
                                   device="cpu")
    eng.add_request([1, 2, 3], 3)
    assert len(eng.run_to_completion()[0]) == 6
