"""The port's GPT serving layer against the JAX package's.

The GPT layer of the serving megakernels (LayerNorm with bias, one fused
qkv product split per head as ``[q | k | v]``, bias and GELU epilogues,
no RoPE) through ``decode_block`` / ``prefill_block`` with a GPT spec.
Inputs are made with numpy from a seed and handed to both packages; on the
CPU the port runs its plain versions:

* a GPT ``decode_block`` and its ``prefill_block`` twin (``start > 0``, a
  padded tail) against the JAX reference tier (``backend="xla"``) and the
  Pallas tier in interpret mode, fp32 1e-5 and bf16 2e-2, outputs and
  pools (the JAX tests' geometry: H 32, 4 heads, D 8, F 48, pages of 4,
  lengths 9 / 5 / 0 and an inactive slot);
* ``decode_block_spec`` field for field against the JAX one;
* ``chip_smoke.gpt_paged_rollout`` (the card's GPT serving phase) for a
  2-layer fp32 GPT against JAX ``gpt_generate``: greedy ids identical,
  the last step's logits within 1e-4;
* the plain versions of the new kernel modes (the LayerNorm rows, the
  bias / GELU epilogues, the qkv split, the unrotated K / V write) against
  their JAX counterparts;
* the engine's refusal of a GPT config (the quantized GPT layer:
  ``tests/test_torch_gpt_quant_serving.py``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_gpt_serving.py
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

from paddle_tpu.core.flags import FLAGS, set_flags
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops import decode_block as jdb
from paddle_tpu.ops import paged_kv as jkv
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import decode_block as tdb
from paddle_tpu_torch.ops.cuda import kernels as K

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

H, HQ, D, F, BS, NB, MB = 32, 4, 8, 48, 4, 16, 6
TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
DTS = ["fp32", "bf16"]
LIVE = [0, 1, 2]            # slot 3 is inactive (table all -1, length 0)
VARIANT = dict(norm="ln", activation="gelu", eps=1e-5, rope=False,
               fused_qkv=True, bias=True)


def _w(rng, *shape, scale=0.1):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _gpt_layer(rng):
    return {"ln1_w": _w(rng, H, scale=1.0) + 1.0, "ln1_b": _w(rng, H),
            "qkv_w": _w(rng, H, 3 * H), "qkv_b": _w(rng, 3 * H),
            "proj_w": _w(rng, H, H), "proj_b": _w(rng, H),
            "ln2_w": _w(rng, H, scale=1.0) + 1.0, "ln2_b": _w(rng, H),
            "fc1_w": _w(rng, H, F), "fc1_b": _w(rng, F),
            "fc2_w": _w(rng, F, H), "fc2_b": _w(rng, H)}


def _specs():
    geo = dict(hidden=H, num_heads=HQ, kv_heads=HQ, head_dim=D,
               block_size=BS, **VARIANT)
    return jdb.DecodeBlockSpec(**geo), tdb.DecodeBlockSpec(**geo)


def _decode_case(seed=21):
    rng = np.random.default_rng(seed)
    bt = np.full((4, MB), -1, np.int32)
    bt[0, :3] = [2, 5, 7]
    bt[1, :2] = [1, 4]
    bt[2, 0] = 9
    return dict(x=_w(rng, 4, H, scale=0.5), lp=_gpt_layer(rng),
                pool_k=_w(rng, NB, BS, HQ, D), pool_v=_w(rng, NB, BS, HQ, D),
                bt=bt, lengths=np.array([9, 5, 0, 0], np.int32))


def _prefill_case(start=5, Ts=8, valid=5, seed=22):
    rng = np.random.default_rng(seed)
    bt_row = np.full((MB,), -1, np.int32)
    nb = -(-(start + Ts) // BS)
    bt_row[:nb] = [2, 5, 7, 9, 11, 13][:nb]
    pos = start + np.arange(Ts)
    blk = np.maximum(bt_row, 0)[pos // BS].astype(np.int32)
    blk[valid:] = NB                     # the padded tail: dropped writes
    mask = np.arange(MB * BS)[None, None, None, :] <= pos[None, None, :, None]
    return dict(x=_w(rng, 1, Ts, H, scale=0.5), lp=_gpt_layer(rng),
                pool_k=_w(rng, NB, BS, HQ, D), pool_v=_w(rng, NB, BS, HQ, D),
                blk=blk, off=(pos % BS).astype(np.int32), bt_row=bt_row,
                mask=mask, start=start, valid=valid)


def _jax(a, dt):
    return jnp.asarray(a, JDT[dt])


def _torch(a, dt):
    return torch.tensor(a, dtype=TDT[dt])


def _pallas(fn):
    old = FLAGS.pallas_interpret
    set_flags({"pallas_interpret": True})
    try:
        return fn()
    finally:
        set_flags({"pallas_interpret": old})


def _np(outs):
    return [np.asarray(o, np.float32) if not isinstance(o, torch.Tensor)
            else o.float().numpy() for o in outs]


@pytest.mark.parametrize("dt", DTS)
def test_gpt_decode_block_matches_jax_tiers(dt):
    """The plain GPT decode layer against the JAX reference tier (every
    row) and the interpret-mode Pallas tier (live rows: an unmapped
    current page is tier-dependent in the JAX package), pools too."""
    c = _decode_case()
    jspec, tspec = _specs()

    def run_jax(backend):
        fn = jax.jit(functools.partial(jdb.decode_block, spec=jspec,
                                       backend=backend))
        return _np(fn(
            _jax(c["x"], dt), {k: _jax(v, dt) for k, v in c["lp"].items()},
            _jax(c["pool_k"], dt), _jax(c["pool_v"], dt),
            jnp.asarray(c["bt"]), jnp.asarray(c["lengths"]), None, None))
    got = _np(tdb.decode_block(
        _torch(c["x"], dt), {k: _torch(v, dt) for k, v in c["lp"].items()},
        _torch(c["pool_k"], dt), _torch(c["pool_v"], dt),
        torch.from_numpy(c["bt"]), torch.from_numpy(c["lengths"]), None,
        None, spec=tspec))
    for r, g in zip(run_jax("xla"), got):
        np.testing.assert_allclose(g, r, **TOL[dt])
    ref = _pallas(lambda: run_jax("pallas"))
    np.testing.assert_allclose(got[0][LIVE], ref[0][LIVE], **TOL[dt])
    for r, g in zip(ref[1:], got[1:]):
        np.testing.assert_allclose(g, r, **TOL[dt])
    # the appended tokens' rows only (slots 0..2), nothing of slot 3
    pool0 = _torch(c["pool_k"], dt).float().numpy()
    moved = np.argwhere((got[1] != pool0).any(axis=(2, 3)))
    assert [tuple(m) for m in moved] == [(4, 1), (7, 1), (9, 0)]


@pytest.mark.parametrize("dt", DTS)
def test_gpt_prefill_block_matches_jax_tiers(dt):
    """A chunk at start 5 whose last 3 of 8 rows are a bucket's padded
    tail: the valid rows' outputs and the pools against both JAX tiers,
    the padded rows writing nothing."""
    c = _prefill_case()
    jspec, tspec = _specs()
    v = c["valid"]

    def run_jax(backend):
        fn = jax.jit(functools.partial(jdb.prefill_block, spec=jspec,
                                       start=c["start"], backend=backend))
        return _np(fn(
            _jax(c["x"], dt), {k: _jax(w, dt) for k, w in c["lp"].items()},
            _jax(c["pool_k"], dt), _jax(c["pool_v"], dt),
            jnp.asarray(c["blk"]), jnp.asarray(c["off"]),
            jnp.asarray(c["bt_row"]), jnp.asarray(c["mask"]), None, None))
    got = _np(tdb.prefill_block(
        _torch(c["x"], dt), {k: _torch(w, dt) for k, w in c["lp"].items()},
        _torch(c["pool_k"], dt), _torch(c["pool_v"], dt),
        torch.from_numpy(c["blk"]), torch.from_numpy(c["off"]),
        torch.from_numpy(c["bt_row"]), None, None, spec=tspec,
        start=c["start"]))
    for ref in (run_jax("xla"), _pallas(lambda: run_jax("pallas"))):
        np.testing.assert_allclose(got[0][:, :v], ref[0][:, :v], **TOL[dt])
        for r, g in zip(ref[1:], got[1:]):
            np.testing.assert_allclose(g, r, **TOL[dt])
    pos = c["start"] + np.arange(v)
    written = {(c["bt_row"][p // BS], p % BS) for p in pos}
    pool0 = _torch(c["pool_k"], dt).float().numpy()
    moved = np.argwhere((got[1] != pool0).any(axis=(2, 3)))
    assert {tuple(m) for m in moved} == written


@pytest.mark.parametrize("make", ["gpt_tiny", "gpt_125m", "llama_tiny"])
def test_decode_block_spec_fields_equal_jax(make):
    mod_t, mod_j = (tllama, jllama) if make.startswith("llama") \
        else (tgpt, jgpt)
    got = tdb.decode_block_spec(getattr(mod_t, make)(), 16)
    want = jdb.decode_block_spec(getattr(mod_j, make)(), 16)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_gpt_paged_rollout_matches_jax_gpt_generate():
    """The card phase's rollout on the CPU: 2 layers, fp32, pages of 4 and
    buckets (4, 8), so the 13-token prompt fills 8 + 4 + 4 (one row real:
    chunks at start 8 and 12, a padded tail) and the 6-token one 4 + 4
    (two real); 5 greedy new tokens, decoded together at two lengths."""
    kw = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              max_position_embeddings=64)
    cfg, jcfg = tgpt.GPTConfig(**kw), jgpt.GPTConfig(**kw)
    rng = np.random.default_rng(5)
    L, h, V, P = 2, 64, 128, 64

    def normal(*shape, scale=0.5):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    blocks = {n: (1.0 + 0.1 * normal(1, L, *s) if n.startswith("ln")
                  and n.endswith("_w") else
                  normal(1, L, *s) / float(np.sqrt(s[0])))
              for n, s in tgpt.block_shapes(cfg).items()}
    tree = {"wte": normal(V, h), "wpe": normal(P, h),
            "lnf_w": 1.0 + 0.1 * normal(h), "lnf_b": normal(h, scale=0.1),
            "blocks": blocks}
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device="cpu")
    prompts = [rng.integers(0, V, n) for n in (13, 6)]
    new = 5
    out = chip_smoke.gpt_paged_rollout(tp, cfg, prompts, new, buckets=(4, 8),
                                       block_size=4, device="cpu")
    assert out["chunks"] == [8, 4, 4, 4, 4] and out["steps"] == new - 1
    for b, p in enumerate(prompts):
        want = np.asarray(jgen.gpt_generate(jp, jcfg, p[None], new))[0]
        np.testing.assert_array_equal(out["ids"][b], want)
        # the last step's logits: JAX's prefill over all but the last id
        jpre, _ = jgen.build_gpt_decoder(jcfg, len(want))
        _, jlog = jpre(jp, jnp.asarray(want[None, :-1]))
        np.testing.assert_allclose(out["step_logits"][-1][b].numpy(),
                                   np.asarray(jlog)[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dt", DTS)
def test_layer_norm_rows_plain_matches_jax_make_norm(dt):
    rng = np.random.default_rng(6)
    x, w, b = _w(rng, 5, H, scale=2.0) + 0.3, _w(rng, H) + 1, _w(rng, H)
    jspec, _ = _specs()
    ref = jdb.make_norm(jspec)(_jax(x, dt), _jax(w, dt), _jax(b, dt))
    got = K.layer_norm_rows_ref(_torch(x, dt), _torch(w, dt), _torch(b, dt),
                                1e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dt])


@pytest.mark.parametrize("epi", ["bias", "bias_resid", "bias_gelu"])
@pytest.mark.parametrize("dt", DTS)
def test_gemm_bias_epilogues_plain_match_jax(dt, epi):
    """``gemm_xw_ref`` with a bias (qkv), a bias and a residual (proj,
    fc2), a bias and GELU (fc1) against the JAX reference tier's ops."""
    rng = np.random.default_rng(7)
    x, w, b, r = _w(rng, 3, H), _w(rng, H, F), _w(rng, F), _w(rng, 3, F)
    jx, jw, jb, jr = (_jax(a, dt) for a in (x, w, b, r))
    y = jx @ jw + jb
    ref = {"bias": y, "bias_resid": jr + y,
           "bias_gelu": jax.nn.gelu(y, approximate=True)}[epi]
    tx, tw, tb, tr = (_torch(a, dt) for a in (x, w, b, r))
    got = K.gemm_xw_ref(tx, tw, bias=tb, gelu=epi == "bias_gelu",
                        residual=tr if epi == "bias_resid" else None)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dt])


def test_qkv_split_plain_matches_jax_fused_layout():
    """The fused product's columns split per head as [q | k | v]: head h's
    q is columns 3Dh .. 3Dh + D, not the first H·D columns."""
    rng = np.random.default_rng(8)
    jspec, _ = _specs()
    y, w, b = _w(rng, 3, H), _w(rng, H, 3 * H), _w(rng, 3 * H)
    ref = jdb._qkv(jnp.asarray(y), {"qkv_w": jnp.asarray(w),
                                    "qkv_b": jnp.asarray(b)}, jspec, (3,))
    got = K.qkv_split_ref(K.gemm_xw_ref(torch.from_numpy(y),
                                        torch.from_numpy(w),
                                        bias=torch.from_numpy(b)), D)
    for g, r in zip(got, ref):
        assert g.shape == (3, H) and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(r).reshape(3, H),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dt", DTS)
def test_unrotated_kv_write_plain_matches_jax_paged_append(dt):
    """``rope_kv_write_ref`` without cos / sin: q and k come back as they
    went in, and the pools equal JAX ``paged_append``'s bit for bit
    (slot 3 inactive, slot 0 at a page boundary)."""
    c = _decode_case(seed=9)
    rng = np.random.default_rng(10)
    q, k, v = (_w(rng, 4, HQ * D) for _ in range(3))
    pk, pv = _torch(c["pool_k"], dt), _torch(c["pool_v"], dt)
    tq, tk = _torch(q, dt), _torch(k, dt)
    rq, rk = K.rope_kv_write_ref(tq, tk, _torch(v, dt), None, None, pk, pv,
                                 head_dim=D,
                                 block_table=torch.from_numpy(c["bt"]),
                                 lengths=torch.from_numpy(c["lengths"]))
    assert torch.equal(rq, tq) and torch.equal(rk, tk)
    jk, jv = jkv.paged_append(
        _jax(c["pool_k"], dt), _jax(c["pool_v"], dt),
        _jax(k, dt).reshape(4, HQ, D), _jax(v, dt).reshape(4, HQ, D),
        jnp.asarray(c["bt"]), jnp.asarray(c["lengths"]), BS)
    np.testing.assert_array_equal(pk.float().numpy(),
                                  np.asarray(jk, np.float32))
    np.testing.assert_array_equal(pv.float().numpy(),
                                  np.asarray(jv, np.float32))


def test_engine_refuses_gpt_configs_naming_the_ops():
    """The JAX engine serves Llama configs only, so the port's refuses GPT
    and names the ops that serve a GPT layer."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    cfg = tgpt.gpt_tiny()
    params = tgpt.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with pytest.raises(NotImplementedError,
                       match="Llama configs only.*decode_block"):
        ContinuousBatchingEngine(cfg, params, max_batch=2, device="cpu")
