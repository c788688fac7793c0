"""The port's KV-cache generation against the JAX package's.

One numpy parameter tree (blocks ``[1, L, ...]`` as the JAX train steps
store them) goes to the JAX package as it is and to the port through
``bridge.params_from_numpy``; prompts come from a numpy seed.  In fp32 on
the CPU (the port's plain versions; the JAX package's reference tier):

* ``llama_generate`` greedy ids identical, unquantized and through
  ``quantize_llama_params`` in int8 and int4 (the port's quantized tree
  equal leaf for leaf to the JAX one handed over by the bridge), with the
  prefill logits at 1e-5 and the first decode step's at 1e-5;
* ``gpt_generate`` greedy ids identical, with and without eos freezing;
* the filtered logits of top-k / top-p sampling equal to the ones the JAX
  ``sample_logits`` hands to ``jax.random.categorical``;
* seeded sampling (``seed=``, no ``generator=``) identical to the JAX
  package's ids, over ``ops/threefry.py``'s ``split`` and shaped bits,
  which equal ``jax.random.split``'s and ``jax.random.bits``' words;
* greedy speculative decoding identical (ids and acceptance stats);
* the entry points default to CUDA and refuse the configurations outside
  this slice by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import generation as jgen
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import threefry

B, T0, NEW = 2, 6, 5


def _tree(shapes, top, seed):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)
    blocks = {n: (1.0 + 0.1 * normal(1, *s) if n.startswith("ln") else
                  normal(1, *s) / float(np.sqrt(s[0]))) for n, s in shapes.items()}
    return {**{n: normal(*s) for n, s in top.items()}, "blocks": blocks}


def _layered(shapes, L):
    return {n: (L,) + s for n, s in shapes.items()}


@pytest.fixture(scope="module")
def llama():
    cfg = tllama.llama_tiny()
    h, V = cfg.hidden_size, cfg.vocab_size
    tree = _tree(_layered(tllama.block_shapes(cfg), cfg.num_layers),
                 {"wte": (V, h), "head": (h, V), "lnf_w": (h,)}, seed=0)
    tree["lnf_w"] = 1.0 + 0.1 * tree["lnf_w"]
    ids = np.random.default_rng(1).integers(0, V, (B, T0)).astype(np.int32)
    return cfg, jllama.llama_tiny(), tree, ids


@pytest.fixture(scope="module")
def gpt():
    cfg = tgpt.gpt_tiny()
    h, V, P = cfg.hidden_size, cfg.vocab_size, cfg.max_position_embeddings
    tree = _tree(_layered(tgpt.block_shapes(cfg), cfg.num_layers),
                 {"wte": (V, h), "wpe": (P, h), "lnf_w": (h,),
                  "lnf_b": (h,)}, seed=2)
    ids = np.random.default_rng(3).integers(0, V, (B, T0)).astype(np.int32)
    return cfg, jgpt.gpt_tiny(), tree, ids


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("quant", [None, "weight_only_int8",
                                   "weight_only_int4"],
                         ids=["bf16-path", "int8", "int4"])
def test_llama_greedy_ids_and_logits_match_jax(llama, quant):
    cfg, jcfg, tree, ids = llama
    jp = _jax_tree(tree)
    tp = params_from_numpy(tree, device="cpu")
    if quant is not None:
        jp = jgen.quantize_llama_params(jp, quant)
        tp = tgen.quantize_llama_params(tp, quant)
        handed = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   dtype="float32", device="cpu")
        for name, leaf in tp["blocks"].items():
            assert leaf.dtype == handed["blocks"][name].dtype, name
            assert torch.equal(leaf, handed["blocks"][name]), name
    want = np.asarray(jgen.llama_generate(jp, jcfg, ids, NEW, quant=quant))
    got = tgen.llama_generate(tp, cfg, ids, NEW, quant=quant, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)

    jpre, jstep = jgen.build_llama_decoder(jcfg, T0 + NEW, quant=quant)
    tpre, tstep = tgen.build_llama_decoder(cfg, T0 + NEW, quant=quant,
                                           device="cpu")
    jcache, jlog = jpre(jp, jnp.asarray(ids))
    tcache, tlog = tpre(tp, torch.from_numpy(ids).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)
    tok = want[:, T0]
    _, jlog = jstep(jp, jcache, jnp.asarray(tok), T0)
    _, tlog = tstep(tp, tcache, torch.from_numpy(tok.copy()).long(), T0)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("eos", [None, "first"], ids=["no-eos", "eos"])
def test_gpt_greedy_ids_match_jax(gpt, eos):
    cfg, jcfg, tree, ids = gpt
    jp, tp = _jax_tree(tree), params_from_numpy(tree, device="cpu")
    eos_id = None
    if eos:      # a token that row 0 emits mid-rollout: later ones freeze
        free = np.asarray(jgen.gpt_generate(jp, jcfg, ids, NEW))
        eos_id = int(free[0, T0 + 1])
    want = np.asarray(jgen.gpt_generate(jp, jcfg, ids, NEW,
                                        eos_token_id=eos_id))
    got = tgen.gpt_generate(tp, cfg, ids, NEW, eos_token_id=eos_id,
                            device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    if eos:
        assert (got[0, T0 + 2:] == eos_id).all()


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.7), (7, 0.5)])
def test_filtered_logits_match_jax(monkeypatch, top_k, top_p):
    logits = np.random.default_rng(4).standard_normal((3, 40)).astype(
        np.float32) * 3
    logits[1, 5] = logits[1, 6]                  # a tie at the cut
    seen = {}

    def capture(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.zeros(lg.shape[:-1], jnp.int32)
    monkeypatch.setattr(jax.random, "categorical", capture)
    jgen.sample_logits(jnp.asarray(logits), jax.random.key(0),
                       temperature=0.7, top_k=top_k, top_p=top_p)
    got = tgen.filter_logits(torch.from_numpy(logits), 0.7, top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), seen["logits"])
    gen = torch.Generator().manual_seed(0)
    draws = tgen.sample_logits(torch.from_numpy(logits), gen,
                               temperature=0.7, top_k=top_k, top_p=top_p)
    assert np.isfinite(seen["logits"][np.arange(3), draws.numpy()]).all()


@pytest.mark.parametrize("seed,num", [(0, 2), (3, 2), (-7, 3),
                                      (2 ** 40 + 5, 2)])
def test_split_matches_jax(seed, num):
    want = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(seed), num)))
    got = threefry.split(threefry.prng_key(seed), num)
    assert [tuple(int(w) for w in k) for k in want] == got


@pytest.mark.parametrize("shape", [(7,), (3, 40), (2, 3, 5)])
def test_shaped_bits_match_jax(shape):
    key = jax.random.key(11)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    k0, k1 = threefry.prng_key(11)
    got = threefry.random_bits(k0, k1, shape)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_seeded_sampled_ids_match_jax(llama, gpt, family):
    cfg, jcfg, tree, ids = llama if family == "llama" else gpt
    jp, tp = _jax_tree(tree), params_from_numpy(tree, device="cpu")
    kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=3)
    jrun = jgen.llama_generate if family == "llama" else jgen.gpt_generate
    trun = tgen.llama_generate if family == "llama" else tgen.gpt_generate
    want = np.asarray(jrun(jp, jcfg, ids, NEW, **kw))
    got = trun(tp, cfg, ids, NEW, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    # the draws are not the greedy ones
    greedy = trun(tp, cfg, ids, NEW, device="cpu")
    assert not torch.equal(got, greedy)


def test_sampled_rollouts_follow_the_generator(llama):
    cfg, _, tree, ids = llama
    tp = params_from_numpy(tree, device="cpu")

    def run(seed):
        return tgen.llama_generate(
            tp, cfg, ids, NEW, temperature=1.0, top_k=50, device="cpu",
            generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


def test_speculative_greedy_matches_jax(llama):
    cfg, jcfg, tree, ids = llama
    dcfg = tllama.llama_tiny(num_layers=1)
    dtree = _tree(_layered(tllama.block_shapes(dcfg), 1),
                  {"wte": (256, 64), "head": (64, 256), "lnf_w": (64,)},
                  seed=5)
    dtree["lnf_w"] = 1.0 + 0.1 * dtree["lnf_w"]
    want, wstats = jgen.llama_speculative_generate(
        _jax_tree(tree), jcfg, _jax_tree(dtree),
        jllama.llama_tiny(num_layers=1), ids, NEW, num_draft=3)
    got, stats = tgen.llama_speculative_generate(
        params_from_numpy(tree, device="cpu"), cfg,
        params_from_numpy(dtree, device="cpu"), dcfg, ids, NEW,
        num_draft=3, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == wstats


def test_entry_points_default_to_cuda(llama):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    cfg, _, tree, ids = llama
    tp = params_from_numpy(tree, device="cpu")
    for call in (lambda: tgen.llama_generate(tp, cfg, ids, 2),
                 lambda: tgen.build_gpt_decoder(tgpt.gpt_tiny(), 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_bridge_keeps_quantized_codes_and_scales():
    """``params_from_numpy(..., dtype="bfloat16")`` casts the float
    weights and leaves the int8 codes and fp32 scales as they are."""
    rng = np.random.default_rng(6)
    codes = rng.integers(-128, 128, (1, 2, 8, 4)).astype(np.int8)
    scale = rng.random((1, 2, 4)).astype(np.float32) * 1e-3
    tree = {"wte": rng.standard_normal((16, 8)).astype(np.float32),
            "blocks": {"q_w__q": codes, "q_w__s": scale,
                       "ln1_w": np.ones((1, 2, 8), np.float32)}}
    out = params_from_numpy(tree, dtype="bfloat16", device="cpu")
    assert out["wte"].dtype == out["blocks"]["ln1_w"].dtype == torch.bfloat16
    assert out["blocks"]["q_w__q"].dtype == torch.int8
    assert out["blocks"]["q_w__s"].dtype == torch.float32
    np.testing.assert_array_equal(out["blocks"]["q_w__q"].numpy(),
                                  codes.reshape(2, 8, 4))
    np.testing.assert_array_equal(out["blocks"]["q_w__s"].numpy(),
                                  scale.reshape(2, 4))


@pytest.mark.parametrize("bad", ["dynamic rope", "moe", "too long",
                                 "quant name"])
def test_refusals(llama, bad):
    cfg, _, tree, ids = llama
    tp = params_from_numpy(tree, device="cpu")
    if bad == "dynamic rope":
        c = tllama.llama_tiny(rope_scaling={
            "rope_type": "dynamic", "factor": 2.0,
            "original_max_position_embeddings": 64})
        with pytest.raises(NotImplementedError, match="dynamic-NTK"):
            tgen.build_llama_decoder(c, 16, device="cpu")
    elif bad == "moe":
        with pytest.raises(NotImplementedError, match="item 15"):
            tgen.build_llama_decoder(tllama.llama_tiny(moe_num_experts=4),
                                     16, device="cpu")
    elif bad == "too long":
        with pytest.raises(ValueError, match="max_position_embeddings"):
            tgen.llama_generate(tp, cfg, ids, cfg.max_position_embeddings,
                                device="cpu")
    else:
        with pytest.raises(ValueError):
            tgen.build_llama_decoder(cfg, 16, quant="int3", device="cpu")
