"""The port's quantized GPT serving layer against the JAX package's.

The GPT layer (LayerNorm with bias, one fused qkv product split per head
as ``[q | k | v]``, bias and GELU epilogues, no RoPE) with weight-only
int8 / int4 matmuls (per channel or groups of 64) and over full-width or
int8 paged-KV pools, through ``decode_block`` / ``prefill_block`` with
``decode_block_spec(gpt_cfg, bs, weight_dtype, group_size)``.  Inputs are
made with numpy from a seed, the matmuls exported by the JAX package's
numpy export (``_quantize_matrix``), and the same codes handed to both
packages; on the CPU the port runs its plain versions:

* the decode layer and its prefill twin (``start > 0``, a padded tail)
  against the JAX reference tier (``backend="xla"``, compiled without
  XLA's excess precision, so that its bf16 ops round as written) for every
  weight width and group size over both pools and for full-width weights
  over an int8 pool, fp32 1e-5 and bf16 2e-2, int8 pools by
  ``test_torch_quant_serving._compare_layer``'s rule (bf16 codes at most
  one step apart); and against the Pallas tier in interpret mode in fp32;
* the plain chain's unrotated write into an int8 pool bit-equal to JAX
  ``paged_append`` (decode) and to the JAX prefill scatter;
* ``wo_layer_ref`` with each bias epilogue (the qkv product split per
  head) against JAX ``make_mm`` plus the bias (plus GELU, plus residual);
* ``decode_block_spec`` of a quantized GPT-125M field for field;
* ``chip_smoke.gpt_paged_rollout`` with ``ServeQuantConfig("int8",
  kv_dtype="int8")`` for a 2-layer fp32 GPT against a twin of the rollout
  built here from the JAX package's ``prefill_block`` / ``decode_block``
  over the JAX export: greedy ids identical, the last step's logits
  within 1e-4.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_gpt_quant_serving.py
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.aot.buckets import ShapeBucketRegistry
from paddle_tpu.core.flags import FLAGS, set_flags
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops import decode_block as jdb
from paddle_tpu.ops import paged_kv as jkv
from paddle_tpu.quantization import serve as jserve
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import decode_block as tdb
from paddle_tpu_torch.ops import paged_kv as tkv
from paddle_tpu_torch.ops.cuda import kernels as K
from paddle_tpu_torch.quantization import serve as tserve

from test_torch_quant_serving import _compare_layer

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

H, HQ, D, F, BS, NB, MB = 128, 4, 32, 512, 4, 16, 6
TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
DTS = ["fp32", "bf16"]
VARIANT = dict(norm="ln", activation="gelu", eps=1e-5, rope=False,
               fused_qkv=True, bias=True)
MATMULS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


def _cid(c):
    return f"{c[0]}/g{c[1]}/kv{c[2]}"


# (weight_dtype, group_size, kv_dtype): each weight width and group size
# over a full-width and an int8 pool, and full-width weights over an int8
# pool; in fp32 all of them, in bf16 the three the card phase serves
CONFIGS = [(w, g, kv) for kv in (None, "int8") for w in ("int8", "int4")
           for g in (-1, 64)] + [(None, -1, "int8")]
BF16_CONFIGS = [("int8", -1, "int8"), ("int4", 64, None), (None, -1, "int8")]
LAYER_CASES = ([pytest.param(c, "fp32", id=_cid(c) + "-fp32")
                for c in CONFIGS]
               + [pytest.param(c, "bf16", id=_cid(c) + "-bf16")
                  for c in BF16_CONFIGS])


def _specs(c):
    geo = dict(hidden=H, num_heads=HQ, kv_heads=HQ, head_dim=D,
               block_size=BS, weight_dtype=c[0], group_size=c[1], **VARIANT)
    return jdb.DecodeBlockSpec(**geo), tdb.DecodeBlockSpec(**geo)


def _case(c, seed=22):
    """A GPT layer (its matmuls exported by the JAX package's numpy export
    when ``c`` quantizes weights), pools (int8 codes and scales from JAX
    ``quantize_kv`` when ``c`` quantizes KV), a decode batch (lengths 9 /
    5 / 0 and an inactive slot) and a prefill chunk of 6 rows at start 5
    whose last row is a padded tail."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.06):                   # ~0.7 / sqrt(fan in)
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    lp = {"ln1_w": w(H, scale=0.3) + 1.0, "ln1_b": w(H, scale=0.1),
          "qkv_w": w(H, 3 * H), "qkv_b": w(3 * H, scale=0.1),
          "proj_w": w(H, H), "proj_b": w(H, scale=0.1),
          "ln2_w": w(H, scale=0.3) + 1.0, "ln2_b": w(H, scale=0.1),
          "fc1_w": w(H, F), "fc1_b": w(F, scale=0.1),
          "fc2_w": w(F, H, scale=0.03), "fc2_b": w(H, scale=0.1)}
    if c[0] is not None:
        qc = jserve.ServeQuantConfig(c[0], c[1])
        for name in MATMULS:
            lp[name + "__q"], lp[name + "__s"] = jserve._quantize_matrix(
                lp.pop(name), qc)
    pools = []
    for _ in range(2):
        p = rng.standard_normal((NB, BS, HQ, D)).astype(np.float32)
        if c[2] is not None:
            codes, scale = jkv.quantize_kv(jnp.asarray(p))
            p = (np.asarray(codes), np.asarray(scale))
        pools.append(p)
    bt = np.full((4, MB), -1, np.int32)
    bt[0, :3] = [3, 7, 2]
    bt[1, :2] = [1, 4]
    bt[2, 0] = 9
    Ts, start = 6, 5
    pos = start + np.arange(Ts)
    bt_row = np.full((MB,), -1, np.int32)
    bt_row[:3] = [11, 0, 13]
    blk = bt_row[pos // BS].copy()
    blk[-1] = NB                                  # a padded row: dropped
    mask = np.arange(MB * BS)[None, None, None, :] <= pos[None, None, :, None]
    return dict(lp=lp, pk=pools[0], pv=pools[1], bt=bt,
                lengths=np.array([9, 5, 0, 0], np.int32),
                x=w(4, H, scale=0.5), xp=w(1, Ts, H, scale=0.5), start=start,
                blk=blk.astype(np.int32), off=(pos % BS).astype(np.int32),
                bt_row=bt_row, mask=mask)


def _jpool(p, dt):
    if isinstance(p, tuple):
        return jkv.QuantizedKVPool(jnp.asarray(p[0]), jnp.asarray(p[1]))
    return jnp.asarray(p, JDT[dt])


def _tpool(p, dt):
    if isinstance(p, tuple):
        return tkv.QuantizedKVPool(torch.tensor(p[0]), torch.tensor(p[1]))
    return torch.tensor(p).to(TDT[dt])


def _jlp(lp, dt):
    return {k: (jnp.asarray(v) if "__" in k else jnp.asarray(v, JDT[dt]))
            for k, v in lp.items()}


def _tlp(lp, dt):
    return {k: (torch.tensor(v) if "__" in k else torch.tensor(v).to(TDT[dt]))
            for k, v in lp.items()}


def _exact(fn, *args):
    """``fn(*args)`` as one XLA program that rounds every op to its
    dtype as written: XLA's default excess precision keeps the bf16
    LayerNorm and bias sums of a jitted layer in fp32, which moves the
    bf16 k by a few ulps and its int8 codes by up to two steps."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jax_layer(case, c, dt, op, backend):
    spec, _ = _specs(c)
    j = lambda a: jnp.asarray(a, JDT[dt])                       # noqa: E731
    pk, pv = _jpool(case["pk"], dt), _jpool(case["pv"], dt)
    if op == "decode":
        return _exact(functools.partial(jdb.decode_block, spec=spec,
                                        backend=backend),
                      j(case["x"]), _jlp(case["lp"], dt), pk, pv,
                      jnp.asarray(case["bt"]), jnp.asarray(case["lengths"]),
                      None, None)
    return _exact(functools.partial(jdb.prefill_block, spec=spec,
                                    start=case["start"], backend=backend),
                  j(case["xp"]), _jlp(case["lp"], dt), pk, pv,
                  jnp.asarray(case["blk"]), jnp.asarray(case["off"]),
                  jnp.asarray(case["bt_row"]), jnp.asarray(case["mask"]),
                  None, None)


def _torch_layer(case, c, dt, op):
    _, spec = _specs(c)
    t = lambda a: torch.tensor(a).to(TDT[dt])                 # noqa: E731
    pk, pv = _tpool(case["pk"], dt), _tpool(case["pv"], dt)
    if op == "decode":
        return tdb.decode_block(t(case["x"]), _tlp(case["lp"], dt), pk, pv,
                                torch.tensor(case["bt"]),
                                torch.tensor(case["lengths"]), None, None,
                                spec=spec)
    return tdb.prefill_block(t(case["xp"]), _tlp(case["lp"], dt), pk, pv,
                             torch.tensor(case["blk"]),
                             torch.tensor(case["off"]),
                             torch.tensor(case["bt_row"]), None, None,
                             spec=spec, start=case["start"])


@pytest.mark.parametrize("op", ["decode", "prefill"])
@pytest.mark.parametrize("c,dt", LAYER_CASES)
def test_plain_gpt_layer_matches_jax_reference_tier(c, dt, op):
    """Every row and both pools against the JAX per-op chain (the padded
    prefill row too: both tiers drop its write and compute its row)."""
    case = _case(c)
    _compare_layer(_torch_layer(case, c, dt, op),
                   _jax_layer(case, c, dt, op, "xla"), dt)


@pytest.mark.parametrize("op", ["decode", "prefill"])
@pytest.mark.parametrize("c", [("int8", -1, "int8"), ("int4", 64, None)],
                         ids=_cid)
def test_plain_gpt_layer_matches_pallas_interpret_tier(c, op):
    """fp32, the live slots at decode and the real rows at prefill (a
    padded row's output is tier-dependent and never read); pools whole."""
    case = _case(c)
    old = FLAGS.pallas_interpret
    set_flags({"pallas_interpret": True})
    try:
        ref = _jax_layer(case, c, "fp32", op, "pallas")
    finally:
        set_flags({"pallas_interpret": old})
    got = _torch_layer(case, c, "fp32", op)
    _compare_layer(got, ref, "fp32", rows=[0, 1, 2] if op == "decode"
                   else (slice(None), slice(0, -1)))


@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("dt", DTS)
def test_unrotated_int8_write_plain_equals_jax(dt, mode):
    """``rope_kv_write_ref`` without cos / sin into int8 pools: q and k
    come back as they went in, the codes and scales bit-equal to JAX
    ``paged_append`` (decode: slot 3 inactive, slot 2 at length 0) and to
    the JAX prefill scatter of ``quantize_kv`` (a padded row dropped)."""
    case = _case(("int8", -1, "int8"), seed=23)
    rng = np.random.default_rng(24)
    M = 4 if mode == "decode" else case["blk"].shape[0]
    q, k, v = (rng.standard_normal((M, HQ * D)).astype(np.float32) * 3
               for _ in range(3))
    pk, pv = _tpool(case["pk"], dt), _tpool(case["pv"], dt)
    tq, tk = torch.tensor(q).to(TDT[dt]), torch.tensor(k).to(TDT[dt])
    tgt = (dict(block_table=torch.tensor(case["bt"]),
                lengths=torch.tensor(case["lengths"])) if mode == "decode"
           else dict(block_table=torch.tensor(case["bt_row"]),
                     blk=torch.tensor(case["blk"]),
                     off=torch.tensor(case["off"])))
    rq, rk = K.rope_kv_write_ref(tq, tk, torch.tensor(v).to(TDT[dt]), None,
                                 None, pk, pv, head_dim=D, **tgt)
    assert torch.equal(rq, tq) and torch.equal(rk, tk)
    # op by op (a jitted program may take the scale's division by 127 as a
    # product with its reciprocal, one ulp off the IEEE quotient)
    jk, jv = (jnp.asarray(a, JDT[dt]).reshape(M, HQ, D) for a in (k, v))
    jpools = (_jpool(case["pk"], dt), _jpool(case["pv"], dt))
    if mode == "decode":
        ref = jkv.paged_append(*jpools, jk, jv, jnp.asarray(case["bt"]),
                               jnp.asarray(case["lengths"]), BS)
    else:                                       # prefill_block_xla's scatter
        blk, off = jnp.asarray(case["blk"]), jnp.asarray(case["off"])
        ref = []
        for p, new in zip(jpools, (jk, jv)):
            codes, scale = jkv.quantize_kv(new)
            ref.append(jkv.QuantizedKVPool(p.data.at[blk, off].set(codes),
                                           p.scale.at[blk, off].set(scale)))
    for g, r in zip((pk, pv), ref):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(r.data))
        np.testing.assert_array_equal(g.scale.numpy().view(np.int32),
                                      np.asarray(r.scale).view(np.int32))


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("wq", [("int8", -1), ("int4", 64)],
                         ids=["int8", "int4g64"])
@pytest.mark.parametrize("epi", ["bias_qkv", "bias_resid", "bias_gelu"])
def test_wo_layer_bias_epilogues_plain_match_jax(epi, wq, dt):
    """``wo_layer_ref`` with a bias (the qkv product, split per head), a
    bias and a residual (proj, fc2), a bias and GELU (fc1) against JAX
    ``make_mm`` with the reference tier's bias / GELU / residual ops."""
    rng = np.random.default_rng(25)
    Kd, N = (H, 3 * H) if epi == "bias_qkv" else (H, F)
    x, w, b, r = (rng.standard_normal(s).astype(np.float32) * sc for s, sc in
                  (((3, Kd), 1.0), ((Kd, N), 0.06), ((N,), 0.1),
                   ((3, N), 1.0)))
    codes, scale = jserve._quantize_matrix(w, jserve.ServeQuantConfig(*wq))
    jspec, _ = _specs(wq + (None,))
    jx, jb, jr = (jnp.asarray(a, JDT[dt]) for a in (x, b, r))
    jlp = {"qkv_w__q": jnp.asarray(codes), "qkv_w__s": jnp.asarray(scale),
           "qkv_b": jb}

    def jax_ref(lp, x, b, r):
        if epi == "bias_qkv":                   # the reference tier's split
            return jdb._qkv(x, lp, jspec, (3,))
        y = jdb.make_mm(jspec)(lp, "qkv_w", x) + b
        return r + y if epi == "bias_resid" else jax.nn.gelu(
            y, approximate=True)
    ref = _exact(jax_ref, jlp, jx, jb, jr)
    tx, tb, tr = (torch.tensor(a).to(TDT[dt]) for a in (x, b, r))
    got = K.wo_layer_ref(tx, torch.tensor(codes), torch.tensor(scale),
                         width=wq[0], group_size=wq[1], bias=tb,
                         gelu=epi == "bias_gelu",
                         residual=tr if epi == "bias_resid" else None)
    if epi == "bias_qkv":
        got = K.qkv_split_ref(got, D)
        for g, rr in zip(got, ref):
            assert g.shape == (3, H) and g.is_contiguous()
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(rr, np.float32)
                                       .reshape(3, H), **TOL[dt])
        return
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dt])


@pytest.mark.parametrize("wq", [("int8", -1), ("int8", 64), ("int4", -1),
                                ("int4", 128)],
                         ids=["int8", "int8g64", "int4", "int4g128"])
def test_quantized_gpt_spec_fields_equal_jax(wq):
    got = tdb.decode_block_spec(tgpt.gpt_125m(), 16, *wq)
    want = jdb.decode_block_spec(jgpt.gpt_125m(), 16, *wq)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.weight_dtype, got.group_size) == wq and not got.rope


def _jax_rollout(tree, jcfg, prompts, new, *, buckets, block_size, qc):
    """``chip_smoke.gpt_paged_rollout`` written with the JAX package's
    ``prefill_block`` / ``decode_block`` (reference tier) over its own
    export of ``tree`` (numpy, blocks ``[1, L, ...]``): the same pages,
    chunks, padded tails (blk past the pool), embedding and head, one
    jitted program a chunk size and one a decode step.  Returns ``(ids per
    prompt, the last step's logits [B, V])``."""
    jt = jserve.quantize_params_for_serving(
        tree, jserve.ServeQuantConfig(qc.weight_dtype, qc.group_size,
                                      qc.kv_dtype))
    spec = jdb.decode_block_spec(jcfg, block_size, qc.weight_dtype,
                                 qc.group_size)
    blocks = {k: np.asarray(v)[0] for k, v in jt["blocks"].items()}
    L = next(iter(blocks.values())).shape[0]
    layers = [{k: jnp.asarray(v[i]) for k, v in blocks.items()}
              for i in range(L)]
    head = {k: jnp.asarray(jt[k]) for k in ("wte", "wpe", "lnf_w", "lnf_b")}
    P, BSz = jcfg.max_position_embeddings, block_size
    MBw = -(-P // BSz)
    need = [-(-(len(p) + new) // BSz) for p in prompts]
    NBp = sum(need)
    bt = np.full((len(prompts), MBw), -1, np.int32)
    for b, n in enumerate(need):
        bt[b, :n] = np.arange(sum(need[:b]), sum(need[:b]) + n)
    shape = (NBp, BSz, jcfg.num_heads, jcfg.head_dim)
    pools = [[jkv.QuantizedKVPool(jnp.zeros(shape, jnp.int8),
                                  jnp.zeros(shape[:-1], jnp.float32))
              for _ in range(2)] for _ in range(L)]

    def logits(hd, x):
        x = x.astype(jnp.float32)
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        y = (x - mu) * jax.lax.rsqrt(var + jcfg.layer_norm_eps)
        return ((y * hd["lnf_w"] + hd["lnf_b"])
                @ hd["wte"].astype(jnp.float32).T)

    @jax.jit
    def prefill(hd, layers, pools, toks, pos, blk, bt_row, mask):
        x = (hd["wte"][toks] + hd["wpe"][jnp.minimum(pos, P - 1)])[None]
        for lp, pl in zip(layers, pools):
            x, pl[0], pl[1] = jdb.prefill_block(
                x, lp, pl[0], pl[1], blk, pos % BSz, bt_row, mask, None,
                None, spec=spec, backend="xla")
        return x[0], pools

    @jax.jit
    def step(hd, layers, pools, tok, lengths, bt):
        x = hd["wte"][tok] + hd["wpe"][lengths]
        for lp, pl in zip(layers, pools):
            x, pl[0], pl[1] = jdb.decode_block(
                x, lp, pl[0], pl[1], bt, lengths, None, None, spec=spec,
                backend="xla")
        lg = logits(hd, x)
        return lg, jnp.argmax(lg, -1), pools

    registry = ShapeBucketRegistry(buckets)
    first = []
    for b, prompt in enumerate(prompts):
        start = 0
        for size, valid in registry.plan_chunks(len(prompt)):
            toks = np.zeros(size, np.int32)
            toks[:valid] = prompt[start:start + valid]
            pos = start + np.arange(size, dtype=np.int32)
            page = np.maximum(bt[b], 0)[np.minimum(pos // BSz, MBw - 1)]
            blk = np.where(np.arange(size) < valid, page, NBp)
            mask = (np.arange(MBw * BSz)[None, None, None, :]
                    <= pos[None, None, :, None])
            x, pools = prefill(head, layers, pools, toks, pos,
                               blk.astype(np.int32), bt[b], mask)
            last = x[valid - 1]
            start += valid
        first.append(np.asarray(jax.jit(logits)(head, last[None]))[0])
    tok = np.argmax(np.stack(first), -1).astype(np.int32)
    lengths = np.asarray([len(p) for p in prompts], np.int32)
    out, lg = [tok], None
    for _ in range(new - 1):
        lg, tok, pools = step(head, layers, pools, tok, lengths, bt)
        out.append(np.asarray(tok))
        lengths = lengths + 1
    new_ids = np.stack(out, 1)
    return ([np.concatenate([np.asarray(p, np.int64), n])
             for p, n in zip(prompts, new_ids)], np.asarray(lg))


def test_quantized_gpt_rollout_matches_jax_twin():
    """The card phase's quantized rollout on the CPU (int8 weights per
    channel and int8 KV, 2 layers, fp32, pages of 4, buckets (4, 8): the
    13-token prompt fills 8 + 4 + 4, one row real in the last chunk, the
    6-token one 4 + 4) against its JAX twin over the JAX export: greedy ids
    identical, the last decode step's logits within 1e-4."""
    kw = dict(vocab_size=128, hidden_size=H, num_layers=2, num_heads=HQ,
              intermediate_size=F, max_position_embeddings=64)
    cfg, jcfg = tgpt.GPTConfig(**kw), jgpt.GPTConfig(**kw)
    rng = np.random.default_rng(5)
    L, V, P = 2, 128, 64

    def normal(*shape, scale=0.5):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    blocks = {n: (1.0 + 0.1 * normal(1, L, *s) if n.startswith("ln")
                  and n.endswith("_w") else
                  normal(1, L, *s) / float(np.sqrt(s[0])))
              for n, s in tgpt.block_shapes(cfg).items()}
    tree = {"wte": normal(V, H), "wpe": normal(P, H),
            "lnf_w": 1.0 + 0.1 * normal(H), "lnf_b": normal(H, scale=0.1),
            "blocks": blocks}
    qc = tserve.ServeQuantConfig("int8", kv_dtype="int8")
    prompts = [rng.integers(0, V, n) for n in (13, 6)]
    new = 5
    out = chip_smoke.gpt_paged_rollout(
        params_from_numpy(tree, device="cpu"), cfg, prompts, new,
        buckets=(4, 8), block_size=4, device="cpu", quant_config=qc)
    assert out["chunks"] == [8, 4, 4, 4, 4] and out["steps"] == new - 1
    ids, last = _jax_rollout(tree, jcfg, prompts, new, buckets=(4, 8),
                             block_size=4, qc=qc)
    for got, want in zip(out["ids"], ids):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(out["step_logits"][-1].numpy(), last,
                               rtol=1e-4, atol=1e-4)
