"""The port's quantized serving against the JAX package's, on the CPU:
``ServeQuantConfig``'s validation; the PTQ export bit-equal to
``paddle_tpu.quantization.quantize_params_for_serving`` (with calibrated
thresholds too); ``quantize_kv`` / ``dequantize_kv`` / ``paged_append``
on int8 pools bit-equal; paged decode attention over an int8 pool and the
quantized ``decode_block_ref`` / ``prefill_block_ref`` against the JAX
reference tier (fp32 1e-5, bf16 2e-2) and against the Pallas tier run in
interpret mode; the engine's greedy ids identical to the JAX engine's for
int8 weights + int8 KV and for int4 groups of 64 (per-step logits 1e-4 in
fp32).  Inputs come from numpy with a seed; parameters go through
``bridge.params_from_numpy``.  The five configs are the JAX package's
``tests/test_quant_serving.py`` ``CONFIGS``."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import parallel as dist
from paddle_tpu.core.flags import FLAGS, set_flags
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops import decode_block as jdb
from paddle_tpu.ops import paged_kv as jkv
from paddle_tpu.parallel.topology import HybridTopology, set_topology
from paddle_tpu.quantization import serve as jserve
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import decode_block as tdb
from paddle_tpu_torch.ops import paged_kv as tkv
from paddle_tpu_torch.quantization import serve as tserve

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
# (weight_dtype, group_size, kv_dtype): tests/test_quant_serving.py CONFIGS
CONFIGS = (("int8", -1, None), ("int8", 64, None), ("int4", 64, None),
           ("int8", -1, "int8"), (None, -1, "int8"))
WEIGHT_CONFIGS = [c for c in CONFIGS if c[0] is not None]


def _cid(c):
    return f"{c[0]}/g{c[1]}/kv{c[2]}"


def _jqc(c):
    return jserve.ServeQuantConfig(*c)


def _tqc(c):
    return tserve.ServeQuantConfig(*c)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("kw", [
    dict(weight_dtype="int2"), dict(kv_dtype="fp8"),
    dict(weight_dtype="int8", group_size=32), dict(group_size=64)],
    ids=["weight_dtype", "kv_dtype", "group_size", "group_without_weights"])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        jserve.ServeQuantConfig(**kw)
    with pytest.raises(ValueError):
        tserve.ServeQuantConfig(**kw)


@pytest.mark.parametrize("c", CONFIGS, ids=_cid)
def test_config_properties_match_jax(c):
    j, t = _jqc(c), _tqc(c)
    for name in ("quantized_weights", "quantized_kv", "algo"):
        assert getattr(t, name) == getattr(j, name)
    assert t.describe() == j.describe()
    assert tserve.quantized_leaf_names("q_w") == \
        jserve.quantized_leaf_names("q_w")


# -------------------------------------------------------------- PTQ export
@pytest.fixture(scope="module")
def model():
    cfg = jllama.llama_tiny()
    topo = dist.init_topology(devices=jax.devices()[:1])
    _, init_fn = jllama.build_llama_train_step(cfg, topo, num_microbatches=1)
    params = init_fn(0)["params"]
    set_topology(HybridTopology())
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, np_tree


def _assert_trees_bit_equal(got, ref):
    assert sorted(got["blocks"]) == sorted(ref["blocks"])
    for k, v in ref["blocks"].items():
        g = got["blocks"][k]
        assert g.dtype == v.dtype, k
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(v.numpy()),
                                      err_msg=k)


@pytest.mark.parametrize("c", WEIGHT_CONFIGS, ids=_cid)
def test_ptq_export_bit_equal_to_jax(model, c):
    _, params, np_tree = model
    ref = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jserve.quantize_params_for_serving(params, _jqc(c))),
        None, "cpu")
    got = tserve.quantize_params_for_serving(
        params_from_numpy(np_tree, None, "cpu"), _tqc(c))
    _assert_trees_bit_equal(got, ref)
    for k in ("wte", "head", "lnf_w"):
        assert torch.equal(got[k], ref[k])


def test_ptq_export_with_thresholds_bit_equal_to_jax(model):
    """Calibrated thresholds (the observer's per-channel absmax, clipped to
    80 % so that they move the codes) give the JAX package's export."""
    _, params, np_tree = model
    jth = jserve.calibrate_weight_thresholds(params)
    tree = params_from_numpy(np_tree, None, "cpu")
    tth = tserve.calibrate_weight_thresholds(tree)
    assert sorted(tth) == sorted(jth)
    for k, v in jth.items():
        np.testing.assert_array_equal(tth[k].numpy(),
                                      np.asarray(v, np.float32))
    clip = {k: np.asarray(v, np.float32) * 0.8 for k, v in jth.items()}
    qc = ("int8", -1, None)
    ref = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jserve.quantize_params_for_serving(
            params, _jqc(qc), thresholds=clip)), None, "cpu")
    got = tserve.quantize_params_for_serving(
        tree, _tqc(qc), thresholds={k: torch.from_numpy(v)
                                    for k, v in clip.items()})
    _assert_trees_bit_equal(got, ref)


@pytest.mark.parametrize("c", WEIGHT_CONFIGS[:3], ids=_cid)
def test_dequantize_block_weight_matches_jax(c):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((130, 48)).astype(np.float32)
    q, s = jserve._quantize_matrix(w, _jqc(c))
    ref = jserve.dequantize_block_weight(q, s, _jqc(c), 130)
    got = tserve.dequantize_block_weight(torch.from_numpy(q),
                                         torch.from_numpy(s), _tqc(c), 130)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------ int8 KV pool
# random rows, and one case a kind of chip_smoke.py's hard rows (quotients
# on half-integers, clipped absmax codes, an all-zero row, tiny values,
# absmax just past the 1e-8 floor): the rows the card's rope_kv_write_q8
# is held to the plain version on
KV_CASES = [pytest.param(dt, None, id=dt) for dt in ("fp32", "bf16")] + [
    pytest.param(dt, kind, id=f"{dt}-{kind.replace(' ', '_')}")
    for dt in ("fp32", "bf16") for kind in cs.Q8_HARD_KINDS]


@pytest.mark.parametrize("dt, kind", KV_CASES)
def test_quantize_dequantize_kv_bit_equal_to_jax(dt, kind):
    rng = np.random.default_rng(1)
    if kind is None:
        x = (rng.standard_normal((6, 3, 16))
             * rng.uniform(1e-3, 30.0, (6, 3, 1))).astype(np.float32)
        x[2, 1] = 0.0                           # a fresh page's zero row
    else:
        n = len(cs.Q8_HARD_KINDS)
        x = cs.q8_hard_rows(16 * n, 64, 28)[cs.Q8_HARD_KINDS.index(kind)::n]
        x = x.reshape(8, 2, 64)
    jc, js = jkv.quantize_kv(jnp.asarray(x, JDT[dt]))
    tc, ts = tkv.quantize_kv(torch.tensor(x).to(TDT[dt]))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    for odt in ("fp32", "bf16"):
        ref = jkv.dequantize_kv(jc, js, JDT[odt])
        got = tkv.dequantize_kv(tc, ts, TDT[odt])
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))


def test_kv_page_bytes_matches_jax():
    for args, kw in (((16, 32, 128), {}), ((16, 32, 128), dict(kv_quant=True)),
                     ((8, 2, 16), dict(dtype_itemsize=4)),
                     ((8, 2, 16), dict(kv_quant=True, dtype_itemsize=4))):
        assert tkv.kv_page_bytes(*args, **kw) == jkv.kv_page_bytes(*args,
                                                                   **kw)


H, HQ, HKV, D, F, BS, NB, MB = 128, 4, 2, 16, 192, 4, 16, 6


def _pools(rng, quant):
    """Random k / v pools as numpy: full width, or (codes, scales) from
    the JAX package's quantize_kv."""
    out = []
    for _ in range(2):
        p = rng.standard_normal((NB, BS, HKV, D)).astype(np.float32)
        if quant:
            c, s = jkv.quantize_kv(jnp.asarray(p))
            p = (np.asarray(c), np.asarray(s))
        out.append(p)
    return out


def _jpool(p, dt):
    if isinstance(p, tuple):
        return jkv.QuantizedKVPool(jnp.asarray(p[0]), jnp.asarray(p[1]))
    return jnp.asarray(p, JDT[dt])


def _tpool(p, dt):
    if isinstance(p, tuple):
        return tkv.QuantizedKVPool(torch.tensor(p[0]), torch.tensor(p[1]))
    return torch.tensor(p).to(TDT[dt])


def _pool_np(p):
    if isinstance(p, tkv.QuantizedKVPool):
        return [p.data.numpy(), _bits(p.scale.numpy())]
    if isinstance(p, jkv.QuantizedKVPool):
        return [np.asarray(p.data), _bits(p.scale)]
    return [np.asarray(p.float() if isinstance(p, torch.Tensor) else p,
                       np.float32)]


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_paged_append_int8_bit_equal_to_jax(dt):
    rng = np.random.default_rng(2)
    pk, pv = _pools(rng, True)
    bt = np.full((4, MB), -1, np.int32)
    bt[0, :3] = [3, 7, 2]
    bt[1, :2] = [1, 4]
    lengths = np.array([9, 5, 0, 2], np.int32)    # rows 2, 3 unmapped
    kn = rng.standard_normal((4, HKV, D)).astype(np.float32)
    vn = rng.standard_normal((4, HKV, D)).astype(np.float32)
    ref = jkv.paged_append(_jpool(pk, dt), _jpool(pv, dt),
                           jnp.asarray(kn, JDT[dt]), jnp.asarray(vn, JDT[dt]),
                           jnp.asarray(bt), jnp.asarray(lengths), BS)
    got = tkv.paged_append(_tpool(pk, dt), _tpool(pv, dt),
                           torch.tensor(kn).to(TDT[dt]),
                           torch.tensor(vn).to(TDT[dt]), torch.tensor(bt),
                           torch.tensor(lengths), BS)
    for g, r in zip(got, ref):
        for ga, ra in zip(_pool_np(g), _pool_np(r)):
            np.testing.assert_array_equal(ga, ra)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_paged_decode_attention_int8_pool_matches_jax(dt):
    rng = np.random.default_rng(3)
    pk, pv = _pools(rng, True)
    bt = np.full((3, MB), -1, np.int32)
    bt[0, :3] = [3, 7, 2]
    bt[1, :2] = [1, 4]
    bt[2, 0] = 9
    lengths = np.array([10, 6, 1], np.int32)
    q = rng.standard_normal((3, HQ, D)).astype(np.float32)
    ref = jkv.paged_decode_attention(jnp.asarray(q, JDT[dt]), _jpool(pk, dt),
                                     _jpool(pv, dt), jnp.asarray(bt),
                                     jnp.asarray(lengths))
    got = tkv.paged_decode_attention(torch.tensor(q).to(TDT[dt]),
                                     _tpool(pk, dt), _tpool(pv, dt),
                                     torch.tensor(bt), torch.tensor(lengths))
    tol = TOL[dt] if dt == "bf16" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def test_pool_quantization_mismatch_is_refused():
    full = torch.zeros(NB, BS, HKV, D)
    quant = tkv.zeros_kv_pool((NB, BS, HKV, D), torch.float32, "cpu",
                              kv_quant=True)
    with pytest.raises(tkv.PagedKVGeometryError, match="quantization"):
        tkv.validate_paged_decode_geometry(
            (2, HQ, D), full, quant, torch.zeros(2, MB), torch.zeros(2))
    assert tkv.pool_geometry(quant) == (NB, BS, HKV, D)
    assert quant.data.dtype == torch.int8 and quant.scale.shape == (
        NB, BS, HKV)


# ------------------------------------------------------- the layer, plain
def _layer_case(c, seed=9):
    """One layer's weights (exported by the JAX package's numpy export when
    ``c`` quantizes weights), pools, a decode batch and a prefill chunk."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.06):                   # ~0.7 / sqrt(fan in)
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    lp = {"ln1_w": w(H, scale=1.0) + 1.0, "q_w": w(H, HQ * D),
          "k_w": w(H, HKV * D), "v_w": w(H, HKV * D), "o_w": w(HQ * D, H),
          "ln2_w": w(H, scale=1.0) + 1.0, "gate_w": w(H, F), "up_w": w(H, F),
          "down_w": w(F, H)}
    wq, gs, kvq = c
    if wq is not None:
        qc = jserve.ServeQuantConfig(wq, gs)
        for name in [k for k in lp if not k.startswith("ln")]:
            q, s = jserve._quantize_matrix(lp.pop(name), qc)
            lp[name + "__q"], lp[name + "__s"] = q, s
    pk, pv = _pools(rng, kvq is not None)
    bt = np.full((4, MB), -1, np.int32)
    bt[0, :3] = [3, 7, 2]
    bt[1, :2] = [1, 4]
    bt[2, 0] = 9
    lengths = np.array([9, 5, 0, 0], np.int32)   # slot 3 inactive
    Ts, start = 6, 5
    pos = start + np.arange(Ts)
    bt_row = np.full((MB,), -1, np.int32)
    bt_row[:3] = [11, 0, 13]
    blk = bt_row[pos // BS].copy()
    blk[-1] = NB                                  # a padded row: dropped
    return dict(lp=lp, pk=pk, pv=pv, bt=bt, lengths=lengths,
                x=w(4, H, scale=0.5), cos=w(4, D, scale=1.0),
                sin=w(4, D, scale=1.0), xp=w(1, Ts, H, scale=0.5),
                cp=w(Ts, D, scale=1.0), sp=w(Ts, D, scale=1.0), start=start,
                blk=blk.astype(np.int32), off=(pos % BS).astype(np.int32),
                bt_row=bt_row)


def _jlp(lp, dt):
    return {k: (jnp.asarray(v) if "__" in k else jnp.asarray(v, JDT[dt]))
            for k, v in lp.items()}


def _tlp(lp, dt):
    return {k: (torch.tensor(v) if "__" in k else torch.tensor(v).to(TDT[dt]))
            for k, v in lp.items()}


def _jax_layer(case, c, dt, op, backend):
    spec = jdb.DecodeBlockSpec(hidden=H, num_heads=HQ, kv_heads=HKV,
                               head_dim=D, block_size=BS, weight_dtype=c[0],
                               group_size=c[1])
    j = lambda a: jnp.asarray(a, JDT[dt])                       # noqa: E731
    pk, pv = _jpool(case["pk"], dt), _jpool(case["pv"], dt)
    # one compiled program a call (as the JAX engine runs the tier): the
    # op-by-op dispatch compiles every primitive on its own
    if op == "decode":
        fn = jax.jit(lambda *a: jdb.decode_block(*a, spec=spec,
                                                 backend=backend))
        return fn(j(case["x"]), _jlp(case["lp"], dt), pk, pv,
                  jnp.asarray(case["bt"]), jnp.asarray(case["lengths"]),
                  j(case["cos"]), j(case["sin"]))
    Ts = case["xp"].shape[1]
    pos = case["start"] + jnp.arange(Ts)
    mask = jnp.arange(MB * BS)[None, None, None, :] \
        <= pos[None, None, :, None]
    fn = jax.jit(lambda *a: jdb.prefill_block(*a, spec=spec,
                                              backend=backend,
                                              start=case["start"]))
    return fn(j(case["xp"]), _jlp(case["lp"], dt), pk, pv,
              jnp.asarray(case["blk"]), jnp.asarray(case["off"]),
              jnp.asarray(case["bt_row"]), mask, j(case["cp"]),
              j(case["sp"]))


def _torch_layer(case, c, dt, op):
    spec = tdb.DecodeBlockSpec(hidden=H, num_heads=HQ, kv_heads=HKV,
                               head_dim=D, block_size=BS, weight_dtype=c[0],
                               group_size=c[1])
    t = lambda a: torch.tensor(a).to(TDT[dt])                 # noqa: E731
    pk, pv = _tpool(case["pk"], dt), _tpool(case["pv"], dt)
    if op == "decode":
        return tdb.decode_block(t(case["x"]), _tlp(case["lp"], dt), pk, pv,
                                torch.tensor(case["bt"]),
                                torch.tensor(case["lengths"]), t(case["cos"]),
                                t(case["sin"]), spec=spec)
    return tdb.prefill_block(t(case["xp"]), _tlp(case["lp"], dt), pk, pv,
                             torch.tensor(case["blk"]),
                             torch.tensor(case["off"]),
                             torch.tensor(case["bt_row"]), t(case["cp"]),
                             t(case["sp"]), spec=spec, start=case["start"])


def _compare_layer(got, ref, dt, rows=None):
    """x_out at the tier tolerance (``rows``: an index of the rows to
    hold); full-width pools at the tolerance; quantized pools: fp32 codes
    equal and scales to 1e-6, bf16 (where the two packages' k may lie one
    bf16 ulp apart) scales to 2e-2 and codes at most one step apart."""
    x_g = got[0].float().numpy()
    x_r = np.asarray(ref[0], np.float32)
    if rows is not None:
        x_g, x_r = x_g[rows], x_r[rows]
    np.testing.assert_allclose(x_g, x_r, **TOL[dt])
    for g, r in zip(got[1:], ref[1:]):
        if isinstance(g, tkv.QuantizedKVPool):
            codes_g = g.data.numpy().astype(np.int32)
            codes_r = np.asarray(r.data).astype(np.int32)
            if dt == "fp32":
                np.testing.assert_array_equal(codes_g, codes_r)
            else:
                assert np.abs(codes_g - codes_r).max() <= 1
            np.testing.assert_allclose(g.scale.numpy(), np.asarray(r.scale),
                                       rtol=1e-6 if dt == "fp32" else 2e-2)
        else:
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(r, np.float32), **TOL[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("op", ["decode", "prefill"])
@pytest.mark.parametrize("c", CONFIGS, ids=_cid)
def test_plain_layer_matches_jax_reference_tier(c, op, dt):
    case = _layer_case(c)
    _compare_layer(_torch_layer(case, c, dt, op),
                   _jax_layer(case, c, dt, op, "xla"), dt)


@pytest.mark.parametrize("op", ["decode", "prefill"])
@pytest.mark.parametrize("c", [CONFIGS[0], CONFIGS[4]], ids=_cid)
def test_plain_layer_matches_pallas_interpret_tier(c, op):
    """fp32, where the Pallas kernels quantize the same k as the reference
    tier."""
    case = _layer_case(c)
    old = FLAGS.pallas_interpret
    set_flags({"pallas_interpret": True})
    try:
        ref = _jax_layer(case, c, "fp32", op, "pallas")
    finally:
        set_flags({"pallas_interpret": old})
    got = _torch_layer(case, c, "fp32", op)
    # decode: the live slots; prefill: the real rows (a padded row's
    # output is tier-dependent and never read by the engine)
    _compare_layer(got, ref, "fp32", rows=[0, 1, 2] if op == "decode"
                   else (slice(None), slice(0, -1)))


@pytest.mark.parametrize("c", WEIGHT_CONFIGS[:3], ids=_cid)
def test_norm_ffn_pair_quantized_matches_jax(c):
    from paddle_tpu.models.llama import llama_tiny as jax_tiny
    cfg = tllama.llama_tiny()
    rng = np.random.default_rng(11)
    lp = {}
    for k, s in tllama.block_shapes(cfg).items():
        w = (rng.standard_normal(s) * 0.1).astype(np.float32)
        if k.startswith("ln"):
            lp[k] = w
        else:
            lp[k + "__q"], lp[k + "__s"] = jserve._quantize_matrix(
                w, _jqc(c))
    x = rng.standard_normal((3, cfg.hidden_size)).astype(np.float32)
    jnorm, jffn = jdb.make_norm_ffn(jax_tiny(), c[0], c[1])
    tnorm, tffn = tdb.make_norm_ffn(cfg, c[0], c[1])
    ref = jffn(_jlp(lp, "fp32"), jnorm(jnp.asarray(x),
                                       jnp.asarray(lp["ln2_w"])))
    got = tffn(_tlp(lp, "fp32"), tnorm(torch.tensor(x),
                                       torch.tensor(lp["ln2_w"])))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL["fp32"])


# ------------------------------------------------------------- the engine
PROMPT_LENS = (5, 20, 37, 9)
BUDGETS = (6, 4, 8, 5)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _torch_engine(tree, qc, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("prefill_buckets", (16,))
    # as the JAX engine these tests compare with is built
    kw.setdefault("enable_prefix_caching", False)
    kw.setdefault("enable_preemption", False)
    return ContinuousBatchingEngine(tllama.llama_tiny(), tree, device="cpu",
                                    quant_config=qc, **kw)


@pytest.mark.parametrize("c", [("int8", -1, "int8"), ("int4", 64, None)],
                         ids=_cid)
def test_greedy_tokens_identical_to_jax_engine(model, c):
    cfg, params, np_tree = model
    jeng = JEngine(cfg, params, max_batch=2, prefill_buckets=(16,),
                   enable_prefix_caching=False, enable_preemption=False,
                   quant_config=_jqc(c))
    teng = _torch_engine(params_from_numpy(np_tree, cfg.dtype, "cpu"),
                         _tqc(c))
    assert isinstance(teng.pool_k, tkv.QuantizedKVPool) == (c[2] is not None)
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
    rep = teng.kv_leak_report()
    assert rep["leaked"] == 0 and rep["unaccounted"] == 0


def test_exported_tree_is_taken_as_it_is(model):
    """The JAX package's export, handed over through the bridge, serves the
    same tokens as a full-width tree exported by the engine; a tree
    exported under another config is refused by its shapes."""
    cfg, params, np_tree = model
    c = ("int4", 64, None)
    exported = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jserve.quantize_params_for_serving(params, _jqc(c))),
        cfg.dtype, "cpu")
    full = params_from_numpy(np_tree, cfg.dtype, "cpu")
    outs = []
    for tree in (exported, full):
        eng = _torch_engine(tree, _tqc(c))
        ids = [eng.add_request(p, n) for p, n in
               zip(_prompts(cfg.vocab_size), BUDGETS)]
        res = eng.run_to_completion()
        outs.append([res[i] for i in ids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="__q"):
        _torch_engine(exported, _tqc(("int8", -1, None)))


def test_non_config_quant_config_raises_type_error(model):
    _, _, np_tree = model
    with pytest.raises(TypeError, match="ServeQuantConfig"):
        _torch_engine(params_from_numpy(np_tree, "float32", "cpu"),
                      object())


def test_weight_quantization_with_moe_is_refused(model):
    _, _, np_tree = model
    cfg = tllama.llama_tiny(moe_num_experts=4)
    with pytest.raises(NotImplementedError, match="dense FFNs"):
        ContinuousBatchingEngine(
            cfg, params_from_numpy(np_tree, "float32", "cpu"), device="cpu",
            quant_config=_tqc(("int8", -1, None)))
    with pytest.raises(NotImplementedError, match="MoE"):
        tdb.make_norm_ffn(cfg, "int8")
