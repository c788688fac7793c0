"""The port's hand-written CUDA kernels against their plain versions.

The ``gpu`` cases run only on a CUDA device (the kernels have no CPU
mode) and skip elsewhere; the CPU cases pin that the per-kernel plain
versions compose to the op-level plain version, so what the card checks
kernel by kernel is what the engine runs.  This file imports no JAX, so
it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: fp32 1e-4 (sums in another order over K up to 11008),
bf16 2e-2 relative and absolute (one bf16 rounding of each stage)."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import decode_block as tdb
from paddle_tpu_torch.ops.cuda import kernels as K
from paddle_tpu_torch.ops.cuda import layer

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]
IDS = ["fp32", "bf16"]
H, HQ, HKV, D, F, BS, NB = 64, 4, 2, 32, 96, 4, 24


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _close(got, ref, dt):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOL[dt])


def _layer(rng, dt, dev):
    def t(*shape, scale=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev, dt)
    lp = {"ln1_w": t(H) + 1, "q_w": t(H, HQ * D), "k_w": t(H, HKV * D),
          "v_w": t(H, HKV * D), "o_w": t(HQ * D, H), "ln2_w": t(H) + 1,
          "gate_w": t(H, F), "up_w": t(H, F), "down_w": t(F, H)}
    return lp, t


def _decode_case(dt, dev, seed=0):
    rng = np.random.default_rng(seed)
    lp, t = _layer(rng, dt, dev)
    bt = torch.full((4, 8), -1, dtype=torch.int32)
    bt[0, :5] = torch.tensor([3, 7, 2, 11, 5])
    bt[1, :2] = torch.tensor([1, 4])
    bt[2, 0] = 9
    lengths = torch.tensor([17, 5, 0, 0], dtype=torch.int32)
    return dict(x=t(4, H, scale=1.0), lp=lp, pool_k=t(NB, BS, HKV, D, scale=1.0),
                pool_v=t(NB, BS, HKV, D, scale=1.0), bt=bt.to(dev),
                lengths=lengths.to(dev), cos=t(4, D, scale=1.0),
                sin=t(4, D, scale=1.0))


def _spec():
    return tdb.DecodeBlockSpec(hidden=H, num_heads=HQ, kv_heads=HKV,
                               head_dim=D, block_size=BS)


def _chain(c, attn_fn):
    """One decode layer composed from the per-kernel plain versions."""
    lp, spec = c["lp"], _spec()
    pk, pv = c["pool_k"].clone(), c["pool_v"].clone()
    y = K.rms_norm_rows_ref(c["x"], lp["ln1_w"], spec.eps)
    q, k = K.rope_kv_write_ref(
        K.gemm_xw_ref(y, lp["q_w"]), K.gemm_xw_ref(y, lp["k_w"]),
        K.gemm_xw_ref(y, lp["v_w"]), c["cos"], c["sin"], pk, pv,
        head_dim=D, block_table=c["bt"], lengths=c["lengths"])
    attn = attn_fn(q, pk, pv)
    xm = K.gemm_xw_ref(attn, lp["o_w"], residual=c["x"])
    y2 = K.rms_norm_rows_ref(xm, lp["ln2_w"], spec.eps)
    h = K.gemm_xw_ref(y2, lp["gate_w"], w2=lp["up_w"])
    return K.gemm_xw_ref(h, lp["down_w"], residual=xm), pk, pv


def test_kernel_plain_versions_compose_to_the_op():
    """CPU: the chain of per-kernel plain versions is the op's plain
    version (fp32 attention here vs the op's fp32 paged attention)."""
    c = _decode_case(torch.float32, "cpu")
    got = _chain(c, lambda q, pk, pv: K.paged_attention_ref(
        q, pk, pv, block_table=c["bt"], lengths=c["lengths"]))
    ref = tdb.decode_block_ref(c["x"], c["lp"], c["pool_k"].clone(),
                               c["pool_v"].clone(), c["bt"], c["lengths"],
                               c["cos"], c["sin"], spec=_spec())
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


def test_prefill_attention_plain_version_is_causal_over_the_row():
    """CPU: with one table row and positions start + r, the per-kernel
    attention equals the dense masked attention in fp32."""
    from paddle_tpu_torch.models.generation import _dense_masked_attention
    rng = np.random.default_rng(4)
    M, start, mb = 6, 5, 4
    pk = torch.from_numpy(rng.standard_normal((NB, BS, HKV, D)).astype(
        np.float32))
    pv = torch.from_numpy(rng.standard_normal((NB, BS, HKV, D)).astype(
        np.float32))
    q = torch.from_numpy(rng.standard_normal((M, HQ * D)).astype(np.float32))
    bt = torch.tensor([3, 8, 1, -1], dtype=torch.int32)
    got = K.paged_attention_ref(q, pk, pv, block_table=bt, start=start)
    kk = pk[bt.long().clamp(min=0)].reshape(1, -1, HKV, D)
    vv = pv[bt.long().clamp(min=0)].reshape(1, -1, HKV, D)
    mask = tdb.causal_mask(start, M, mb * BS, "cpu")
    ref = _dense_masked_attention(q.reshape(1, M, HQ, D), kk, vv, mask,
                                  1.0 / D ** 0.5)
    torch.testing.assert_close(got, ref.reshape(M, -1), rtol=1e-5,
                               atol=1e-5)


def test_layer_counts_follow_the_chain():
    """CPU: the counter names read by ``launch_counts`` follow the
    library's ``CNT_*`` enum, and every counter is bumped by a launcher
    (one per kernel in its source, one per layer entry point)."""
    import re
    from pathlib import Path
    csrc = Path(layer.__file__).resolve().parents[2] / "kernels" / "csrc"
    enum = re.search(r"enum \{\s*(CNT_DECODE_BLOCK.*?)CNT_NUM",
                     (csrc / "common.cuh").read_text(), re.S).group(1)
    names = [n.strip()[4:].lower() for n in enum.split(",") if n.strip()]
    assert tuple(names) == layer.KERNELS
    assert {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "linear_ce_fwd",
            "linear_ce_dz", "linear_ce_dx", "linear_ce_dw",
            "decode_attention", "wo_int8_small_m", "wo_int8_tiled",
            "wo_int4_small_m", "wo_int4_tiled", "wo_f32", "rms_norm_fwd",
            "layer_norm_fwd", "bias_residual_ln_fwd",
            "swiglu_fwd"} <= set(names)
    src = "".join(f.read_text() for f in sorted(csrc.glob("*.cu")))
    for name in names:
        assert src.count(f"count_launch(CNT_{name.upper()},") == 1, name


# the quantized chain: (weight width, group size, int8 KV pool)
QUANT = [("int8", -1, True), ("int4", -1, True), ("int8", 64, False)]
QIDS = ["int8-kv8", "int4-kv8", "int8g64"]


def _quantized(c, width, gs, kvq, spec=None):
    """``c`` with its layer PTQ-exported (``width`` None: full width) and
    (kvq) its pools int8, and the quantized spec of ``spec`` (default the
    file's Llama layer)."""
    from paddle_tpu_torch.ops import paged_kv as tkv
    from paddle_tpu_torch.quantization import (ServeQuantConfig,
                                               quantize_params_for_serving)
    blocks = quantize_params_for_serving(
        {"blocks": {k: v[None] for k, v in c["lp"].items()}},
        ServeQuantConfig(width, gs))["blocks"]
    out = dict(c, lp={k: v[0] for k, v in blocks.items()})
    if kvq:
        for n in ("pool_k", "pool_v"):
            out[n] = tkv.QuantizedKVPool(*tkv.quantize_kv(c[n]))
    return out, dataclasses.replace(spec or _spec(), weight_dtype=width,
                                    group_size=gs)


def _pool_copy(p):
    from paddle_tpu_torch.ops import paged_kv as tkv
    if tkv.is_quantized_pool(p):
        return tkv.QuantizedKVPool(p.data.clone(), p.scale.clone())
    return p.clone()


@pytest.mark.parametrize("width,gs,kvq", QUANT, ids=QIDS)
def test_quantized_plain_versions_compose_to_the_op(width, gs, kvq):
    """CPU: the quantized chain of per-kernel plain versions (the
    weight-only GEMMs with their epilogues, the RoPE / KV write and the
    attention over int8 pools) is the op's plain version."""
    from paddle_tpu_torch.ops import paged_kv as tkv
    c, spec = _quantized(_decode_case(torch.float32, "cpu"), width, gs, kvq)
    lp = c["lp"]

    def mm(name, y, **kw):
        return K.wo_layer_ref(y, lp[name + "__q"], lp[name + "__s"],
                              width=width, group_size=gs, **kw)
    pk, pv = _pool_copy(c["pool_k"]), _pool_copy(c["pool_v"])
    y = K.rms_norm_rows_ref(c["x"], lp["ln1_w"], spec.eps)
    q, k = K.rope_kv_write_ref(mm("q_w", y), mm("k_w", y), mm("v_w", y),
                               c["cos"], c["sin"], pk, pv, head_dim=D,
                               block_table=c["bt"], lengths=c["lengths"])
    attn = K.paged_attention_ref(q, pk, pv, block_table=c["bt"],
                                 lengths=c["lengths"])
    xm = mm("o_w", attn, residual=c["x"])
    y2 = K.rms_norm_rows_ref(xm, lp["ln2_w"], spec.eps)
    h = mm("up_w", y2, gate=mm("gate_w", y2))
    got = mm("down_w", h, residual=xm)
    rk, rv = _pool_copy(c["pool_k"]), _pool_copy(c["pool_v"])
    ref = tdb.decode_block_ref(c["x"], lp, rk, rv, c["bt"], c["lengths"],
                               c["cos"], c["sin"], spec=spec)
    torch.testing.assert_close(got, ref[0], rtol=1e-5, atol=1e-5)
    for g, r in ((pk, rk), (pv, rv)):
        if kvq:
            assert torch.equal(g.data, r.data)
            assert torch.equal(g.scale, r.scale)
            assert tkv.is_quantized_pool(r)
        else:
            assert torch.equal(g, r)


def test_wo_layout_refuses_what_the_kernels_refuse():
    """CPU: the chain's weight-only GEMM shapes (``layer.wo_layout``)."""
    assert layer.wo_layout(4096, 11008, "int4", 64) == (
        (2048, 11008), (64, 11008), 64)
    assert layer.wo_layout(11008, 4096, "int8", -1) == (
        (11008, 4096), (4096,), layer.PER_CHANNEL_GS)
    assert layer.wo_layout(96, 64, "int8", 64)[1] == (2, 64)
    for args in ((64, 40, "int8", -1), (60, 64, "int8", -1),
                 (64, 64, "int4", 64), (4096, 4104, "int4", 128)):
        with pytest.raises(ValueError):
            layer.wo_layout(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("width,gs,kvq", QUANT, ids=QIDS)
def test_quantized_decode_block_kernel_matches_plain(dt, width, gs, kvq):
    """The quantized chain on the card against its plain version: x at the
    tolerance, an int8 pool's codes at most one step apart (a k a rounding
    apart may take the next code), its scales to 2e-2; the launches are
    the chain's."""
    _need_card()
    c, spec = _quantized(_decode_case(dt, "cuda"), width, gs, kvq)
    rk, rv = _pool_copy(c["pool_k"]), _pool_copy(c["pool_v"])
    ref = tdb.decode_block_ref(c["x"], c["lp"], rk, rv, c["bt"],
                               c["lengths"], c["cos"], c["sin"], spec=spec)
    gk, gv = _pool_copy(c["pool_k"]), _pool_copy(c["pool_v"])
    layer.reset_counts()
    got = tdb.decode_block(c["x"], c["lp"], gk, gv, c["bt"], c["lengths"],
                           c["cos"], c["sin"], spec=spec)
    torch.cuda.synchronize()
    wo = "wo_layer_f32" if dt == torch.float32 else f"wo_layer_{width}_small_m"
    q8 = "_q8" if kvq else ""
    assert {k: n for k, n in layer.launch_counts().items() if n} == {
        "decode_block": 1, "rms_norm_rows": 2, wo: 7,
        "rope_kv_write" + q8: 1, "paged_attention" + q8: 1}
    _close(got[0][:3], ref[0][:3], dt)           # row 3: inactive slot
    for g, r in ((gk, rk), (gv, rv)):
        if kvq:
            assert (g.data.int() - r.data.int()).abs().max() <= 1
            _close(g.scale, r.scale, torch.bfloat16)
        else:
            _close(g, r, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_decode_block_kernel_matches_plain(dt):
    _need_card()
    c = _decode_case(dt, "cuda")
    ref = tdb.decode_block_ref(c["x"], c["lp"], c["pool_k"].clone(),
                               c["pool_v"].clone(), c["bt"], c["lengths"],
                               c["cos"], c["sin"], spec=_spec())
    pk, pv = c["pool_k"].clone(), c["pool_v"].clone()
    got = tdb.decode_block(c["x"], c["lp"], pk, pv, c["bt"], c["lengths"],
                           c["cos"], c["sin"], spec=_spec())
    torch.cuda.synchronize()
    _close(got[0][:3], ref[0][:3], dt)           # row 3: inactive slot
    _close(got[1], ref[1], dt)
    _close(got[2], ref[2], dt)
    changed = (pk != c["pool_k"]).flatten(2).any(-1).nonzero().tolist()
    assert sorted(map(tuple, changed)) == [(4, 1), (5, 1), (9, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("Ts,start,valid", [(16, 0, 16), (24, 5, 20),
                                            (64, 3, 64)])
def test_prefill_block_kernel_matches_plain(dt, Ts, start, valid):
    _need_card()
    rng = np.random.default_rng(2)
    lp, t = _layer(rng, dt, "cuda")
    mb = 24
    bt_row = torch.arange(mb, dtype=torch.int32)
    pools = [t(mb, BS, HKV, D, scale=1.0) for _ in range(2)]
    bt_row = bt_row.cuda()
    pos = start + torch.arange(Ts, device="cuda")
    blk = bt_row.clamp(min=0)[pos // BS]
    blk[valid:] = mb
    blk, off = blk.to(torch.int32), (pos % BS).to(torch.int32)
    x, cos, sin = t(1, Ts, H, scale=1.0), t(Ts, D, scale=1.0), \
        t(Ts, D, scale=1.0)
    ref = tdb.prefill_block_ref(x, lp, pools[0].clone(), pools[1].clone(),
                                blk, off, bt_row, cos, sin, spec=_spec(),
                                start=start)
    pk = pools[0].clone()
    layer.reset_counts()
    got = tdb.prefill_block(x, lp, pk, pools[1].clone(), blk, off, bt_row,
                            cos, sin, spec=_spec(), start=start)
    torch.cuda.synchronize()
    counts = layer.launch_counts()
    gemm = "gemm_xw_f32" if dt == torch.float32 else \
        "gemm_xw_small_m" if Ts <= 16 else "gemm_xw_tiled"
    assert {k: n for k, n in counts.items() if n} == {
        "prefill_block": 1, "rms_norm_rows": 2, gemm: 6,
        "rope_kv_write": 1, "paged_attention": 1}
    torch.cuda.synchronize()
    _close(got[0][:, :valid], ref[0][:, :valid], dt)
    _close(got[1], ref[1], dt)
    _close(got[2], ref[2], dt)
    flat = pk.flatten(0, 1)
    untouched = torch.ones(flat.shape[0], dtype=torch.bool)
    untouched[start:start + valid] = False
    assert torch.equal(flat[untouched.cuda()],
                       pools[0].flatten(0, 1)[untouched.cuda()])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("M", [1, 4, 8, 9, 16, 17, 64, 100, 255, 256, 300])
@pytest.mark.parametrize("Kd,N", [(520, 264), (72, 136), (1096, 392)],
                         ids=["K520-N264", "K72-N136", "K1096-N392"])
@pytest.mark.parametrize("epi", ["none", "resid", "swiglu"])
def test_gemm_xw_matches_plain(dt, M, Kd, N, epi):
    """Both bf16 regimes at their edges (M 8 / 9 and 16 / 17: the decode
    kernel's 8- and 16-row tiles; 256 / 300: one 256-row tile and past
    it), K past a 64-row step and N past a 128-column tile: within
    tolerance, one launch of the regime's kernel a call, and a second call
    bit-identical (the K splits fold in a fixed order)."""
    _need_card()
    rng = np.random.default_rng(M)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.1).to("cuda", dt)
    x, w = t(M, Kd), t(Kd, N)
    kw = {"w2": t(Kd, N)} if epi == "swiglu" else \
        {"residual": t(M, N)} if epi == "resid" else {}
    kernel = "gemm_xw_f32" if dt == torch.float32 else \
        "gemm_xw_small_m" if M <= 16 else "gemm_xw_tiled"
    outs = []
    for _ in range(2):
        layer.reset_counts()
        outs.append(K.gemm_xw_cuda(x, w, **kw))
        torch.cuda.synchronize()
        assert {k: n for k, n in layer.launch_counts().items() if n} == {
            kernel: 1}
    _close(outs[0], K.gemm_xw_ref(x, w, **kw), dt)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_rms_norm_rope_attention_kernels_match_plain(dt):
    _need_card()
    c = _decode_case(dt, "cuda", seed=5)
    eps = 1e-5
    _close(K.rms_norm_rows_cuda(c["x"], c["lp"]["ln1_w"], eps),
           K.rms_norm_rows_ref(c["x"], c["lp"]["ln1_w"], eps), dt)
    rng = np.random.default_rng(6)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dt)
    q, k, v = t(4, HQ * D), t(4, HKV * D), t(4, HKV * D)
    pk_r, pv_r = c["pool_k"].clone(), c["pool_v"].clone()
    rq, rk = K.rope_kv_write_ref(q, k, v, c["cos"], c["sin"], pk_r, pv_r,
                                 head_dim=D, block_table=c["bt"],
                                 lengths=c["lengths"])
    pk, pv = c["pool_k"].clone(), c["pool_v"].clone()
    gq, gk = K.rope_kv_write_cuda(q.clone(), k.clone(), v, c["cos"],
                                  c["sin"], pk, pv, block_table=c["bt"],
                                  lengths=c["lengths"])
    for g, r in ((gq, rq), (gk, rk), (pk, pk_r), (pv, pv_r)):
        _close(g, r, dt)
    _close(K.paged_attention_cuda(rq, pk_r, pv_r, block_table=c["bt"],
                                  lengths=c["lengths"]),
           K.paged_attention_ref(rq, pk_r, pv_r, block_table=c["bt"],
                                 lengths=c["lengths"]), dt)
    torch.cuda.synchronize()


# rope_kv_write at each head_dim the layer takes, with 1, 2, 4 and 8 q
# heads a kv head
ROPE_KV_GD = [(D_, G) for D_ in (32, 64, 128) for G in (1, 2, 4, 8)]


def _rope_kv_inputs(dt, Dh, G, mode, seed=11, Hkv=2, BS=4, NB=24, MB=3):
    """q, k, v, cos, sin, pools and the write targets' keywords.  Decode:
    rows that write (length 5 and 0), an inactive slot (table all -1), a
    length past the table and a page >= NB, all three dropped.  Prefill:
    7 rows through blk / off, the last 2 a padded tail routed to page NB."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dt)
    rows = 5 if mode == "decode" else 7
    if mode == "decode":
        bt = torch.full((rows, MB), -1, dtype=torch.int32)
        bt[0, :2] = torch.tensor([3, 7])
        bt[1, 0] = 9
        bt[3] = torch.tensor([1, 2, 4])
        bt[4, 0] = NB + 3
        kw = dict(block_table=bt.cuda(), lengths=torch.tensor(
            [5, 0, 0, MB * BS, 2], dtype=torch.int32, device="cuda"))
    else:
        pos = 6 + torch.arange(rows)
        bt = torch.tensor([11, 5, 8, 2], dtype=torch.int32)
        blk = bt[pos // BS]
        blk[5:] = NB
        kw = dict(block_table=bt.cuda(), blk=blk.cuda(),
                  off=(pos % BS).to(torch.int32).cuda())
    return (t(rows, Hkv * G * Dh), t(rows, Hkv * Dh), t(rows, Hkv * Dh),
            t(rows, Dh), t(rows, Dh), t(NB, BS, Hkv, Dh), t(NB, BS, Hkv, Dh),
            kw)


def _rope_kv_ref(q, k, v, cos, sin, pk, pv, kw):
    pk, pv = pk.clone(), pv.clone()
    rq, rk = K.rope_kv_write_ref(q, k, v, cos, sin, pk, pv,
                                 head_dim=pk.shape[-1], **kw)
    return torch.cat([t.flatten() for t in (rq, rk, pk, pv)])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("Dh,G", ROPE_KV_GD,
                         ids=[f"D{d}-G{g}" for d, g in ROPE_KV_GD])
def test_rope_kv_write_equals_plain_bit_for_bit(dt, mode, Dh, G):
    """q and k roped in place and the pool rows written equal the plain
    version bit for bit, dropped writes leave the pool alone; each call
    one launch, a second call bit-identical."""
    _need_card()
    q, k, v, cos, sin, pk, pv, kw = _rope_kv_inputs(dt, Dh, G, mode)

    def run():
        qq, kk, gk, gv = q.clone(), k.clone(), pk.clone(), pv.clone()
        K.rope_kv_write_cuda(qq, kk, v, cos, sin, gk, gv, **kw)
        return torch.cat([t.flatten() for t in (qq, kk, gk, gv)])
    got = _once_bitwise(run, "rope_kv_write")
    assert torch.equal(_bits(got),
                       _bits(_rope_kv_ref(q, k, v, cos, sin, pk, pv, kw)))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("Dh,G", ROPE_KV_GD,
                         ids=[f"D{d}-G{g}" for d, g in ROPE_KV_GD])
def test_rope_kv_write_q8_equals_plain_bit_for_bit(dt, mode, Dh, G):
    """Into int8 pools: q and k roped in place, the written rows' codes and
    scales equal ``quantize_kv`` of the plain version's rows bit for bit,
    dropped writes leave codes and scales alone; one launch of
    ``rope_kv_write_q8`` a call, a second call bit-identical."""
    _need_card()
    from paddle_tpu_torch.ops import paged_kv as tkv
    q, k, v, cos, sin, pk, pv, kw = _rope_kv_inputs(dt, Dh, G, mode)
    pk, pv = (tkv.QuantizedKVPool(*tkv.quantize_kv(p)) for p in (pk, pv))

    def flat(qq, kk, gk, gv):
        return torch.cat([t.flatten().int() for t in (
            _bits(qq), _bits(kk), gk.data, _bits(gk.scale), gv.data,
            _bits(gv.scale))])

    def run():
        qq, kk, gk, gv = q.clone(), k.clone(), _pool_copy(pk), _pool_copy(pv)
        K.rope_kv_write_cuda(qq, kk, v, cos, sin, gk, gv, **kw)
        return flat(qq, kk, gk, gv)
    got = _once_bitwise(run, "rope_kv_write_q8")
    rk, rv = _pool_copy(pk), _pool_copy(pv)
    rq, rkk = K.rope_kv_write_ref(q, k, v, cos, sin, rk, rv, head_dim=Dh,
                                  **kw)
    assert torch.equal(got, flat(rq, rkk, rk, rv))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_rope_kv_write_scalar_path_equals_plain(dt):
    """Pointers off 16 bytes (the C entry point takes them; the wrapper
    refuses them) run one pair a thread, bit-equal all the same."""
    _need_card()
    import ctypes
    from paddle_tpu_torch.kernels import build
    q, k, v, cos, sin, pk, pv, kw = _rope_kv_inputs(dt, 64, 4, "decode")
    ref = _rope_kv_ref(q, k, v, cos, sin, pk, pv, kw)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        buf[1:] = t.flatten()
        return buf[1:].view(t.shape)
    qq, kk, vv, cc, ss, gk, gv = map(shifted, (q, k, v, cos, sin, pk, pv))
    a, _ = layer.layer_args(pk, pv, kw["block_table"], M=q.shape[0],
                            lengths=kw["lengths"], cos=cos, sin=sin, q=q,
                            k=k, v=v)
    for name, t in (("q", qq), ("k", kk), ("v", vv), ("cos", cc),
                    ("sin", ss), ("pool_k", gk), ("pool_v", gv)):
        setattr(a, name, t.data_ptr())
    layer.reset_counts()
    build.check(build.library().pt_rope_kv_write(ctypes.byref(a),
                                                  layer.stream_handle()),
                "pt_rope_kv_write")
    torch.cuda.synchronize()
    assert layer.launch_counts()["rope_kv_write"] == 1
    assert torch.equal(_bits(torch.cat([t.flatten() for t in (qq, kk, gk,
                                                              gv)])),
                       _bits(ref))


# ---------------------------------------------------------- paged attention
# (G, head_dim): the group sizes 1, 2, 4, 8 at head_dim 128 and 64, and 32
PATTN_GD = [(1, 128), (2, 64), (4, 128), (8, 64), (8, 128), (1, 32)]
# prefill (Ts, start, G, head_dim): Ts 16 (one 16-row tile; after 600
# positions the rows body), 17 (one mostly empty 64-row tile), 64, 100
# (off the tiles) and 256 after 0, 5 and 300 positions
PATTN_PRE = [(16, 0, 1, 128), (16, 300, 4, 64), (16, 600, 1, 128),
             (17, 300, 1, 128),
             (64, 5, 1, 128), (100, 5, 4, 128), (256, 0, 1, 64),
             (256, 300, 1, 128), (256, 300, 8, 64)]


def _pattn_inputs(dt, G, Dh, seed, rows, Hkv=2, BS=16, NB=400):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dt)
    return (t(rows, Hkv * G * Dh), t(NB, BS, Hkv, Dh), t(NB, BS, Hkv, Dh),
            rng.permutation(NB))


def _once_bitwise(fn, name):
    """``fn()`` twice: one launch of ``name`` each, bit-identical."""
    outs = []
    for _ in range(2):
        layer.reset_counts()
        outs.append(fn())
        torch.cuda.synchronize()
        assert {k: n for k, n in layer.launch_counts().items() if n} == {
            name: 1}
    assert torch.equal(outs[0], outs[1])
    return outs[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("G,Dh", PATTN_GD,
                         ids=[f"G{g}-D{d}" for g, d in PATTN_GD])
def test_paged_attention_decode_matches_plain(dt, G, Dh):
    """Rows at lengths 0, 15, 16, 17 (around one 16-row page), 2047 (the
    table's 128 pages, over every one of the 8 splits) and 700 with an
    unmapped (-1) entry inside its live pages; one launch, a second call
    bit-identical."""
    _need_card()
    lengths = [0, 15, 16, 17, 2047, 700]
    q, pk, pv, perm = _pattn_inputs(dt, G, Dh, 31, len(lengths))
    bt = torch.full((len(lengths), 128), -1, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-(n + 1) // 16)
        bt[b, :need] = torch.from_numpy(perm[used:used + need].astype(
            np.int32))
        used += need
    bt[5, 10] = -1
    kw = dict(block_table=bt.cuda(),
              lengths=torch.tensor(lengths, dtype=torch.int32,
                                   device="cuda"))
    got = _once_bitwise(lambda: K.paged_attention_cuda(q, pk, pv, **kw),
                        "paged_attention")
    _close(got, K.paged_attention_ref(q, pk, pv, **kw), dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("Ts,start,G,Dh", PATTN_PRE,
                         ids=[f"Ts{a}-s{b}-G{c}-D{d}"
                              for a, b, c, d in PATTN_PRE])
def test_paged_attention_prefill_matches_plain(dt, Ts, start, G, Dh):
    """One sequence's chunk at positions start + r over a 64-page table
    row with unmapped (-1) entries past its pages; bf16 chunks of more
    than 16 rows take the tensor-core body (P rounded to bf16: within the
    bf16 tolerance of the fp32 plain version); one launch, a second call
    bit-identical."""
    _need_card()
    q, pk, pv, perm = _pattn_inputs(dt, G, Dh, 32, Ts)
    bt = torch.full((64,), -1, dtype=torch.int32)
    need = -(-(start + Ts) // 16)
    bt[:need] = torch.from_numpy(perm[:need].astype(np.int32))
    kw = dict(block_table=bt.cuda(), start=start)
    got = _once_bitwise(lambda: K.paged_attention_cuda(q, pk, pv, **kw),
                        "paged_attention")
    _close(got, K.paged_attention_ref(q, pk, pv, **kw), dt)


# ---------------------------------------------------------- flash attention
# (B, Sq, Sk, Hq, Hkv, D, causal, segments, bias shape or None)
FLASH_CASES = [(2, 128, 128, 4, 4, 128, True, False, None),
               (1, 100, 100, 4, 2, 64, True, False, None),
               (2, 70, 130, 2, 1, 64, False, False, None),
               (2, 130, 70, 2, 1, 64, True, False, None),
               (2, 96, 96, 2, 2, 64, True, True, None),
               (2, 64, 64, 4, 2, 64, False, False, (1, 4)),
               (2, 80, 80, 4, 2, 128, True, False, (2, 1)),
               # less than one tile; off the 64- and 128-row tiles; GQA
               # G 8; causal Sq > Sk across tiles at D 128
               (2, 1, 1, 2, 1, 64, True, False, None),
               (2, 17, 17, 4, 2, 128, False, False, None),
               (1, 200, 200, 4, 4, 64, True, False, None),
               (1, 200, 200, 4, 2, 128, True, False, None),
               (1, 256, 256, 8, 1, 64, True, False, None),
               (1, 200, 130, 4, 2, 128, True, False, None),
               # the forward's two bodies: causal S 2048 (masked diagonal
               # tiles beside plain ones in a block); segment ids off the
               # diagonal with Sk off the 64-row tiles; causal Sq > Sk
               # with a bias
               (1, 2048, 2048, 2, 2, 64, True, False, None),
               (2, 200, 200, 4, 2, 128, False, True, None),
               (2, 200, 130, 4, 2, 64, True, False, (2, 1))]
FLASH_IDS = ["mha-causal-d128", "gqa-ragged-d64", "sq-ne-sk-full",
             "sq-gt-sk-causal", "segments", "bias-1hq", "bias-b1-d128",
             "s1-causal", "s17-full-d128", "s200-d64", "s200-d128",
             "gqa-g8-causal", "sq-gt-sk-causal-d128", "s2048-causal-d64",
             "segments-full-sk200-d128", "sq-gt-sk-causal-bias-d64"]


def _flash_case(case, dt, seed=7):
    from paddle_tpu_torch.ops.flash_attention import flash_fwd_ref
    B, Sq, Sk, Hq, Hkv, D, causal, seg, bias = case
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dt)
    c = dict(q=t(B, Sq, Hq, D), k=t(B, Sk, Hkv, D), v=t(B, Sk, Hkv, D),
             do=t(B, Sq, Hq, D), scale=D ** -0.5, causal=causal)
    c["seg_q"] = c["seg_k"] = c["bias"] = None
    if seg:                                 # contiguous runs: no empty row
        s = np.sort(rng.integers(0, 3, (B, Sq)), axis=1).astype(np.int32)
        c["seg_q"] = c["seg_k"] = torch.from_numpy(s).cuda()
    if bias is not None:
        c["bias"] = torch.from_numpy(rng.standard_normal(
            bias + (Sq, Sk)).astype(np.float32)).cuda()
    c["out"], c["lse"] = flash_fwd_ref(c["q"], c["k"], c["v"], c["scale"],
                                       causal, c["seg_q"], c["seg_k"],
                                       c["bias"])
    return c


def _flash_ok(name, got, plain, truth, dt):
    """fp32: within 1e-4 of the plain version.  bf16: within 2e-2, or no
    further from the fp32 result than 1.5 x the plain bf16 version (the
    kernel rounds p against its running max, the plain version against
    the row's final max)."""
    g, p, t = got.float(), plain.float(), truth.float()
    assert torch.isfinite(g).all(), name
    tol = 1e-4 if dt == torch.float32 else 2e-2
    if bool(((g - p).abs() <= tol + tol * p.abs()).all()):
        return
    assert dt == torch.bfloat16, f"{name}: {float((g - p).abs().max())}"
    assert float((g - t).abs().max()) <= 1.5 * float((p - t).abs().max()), \
        name


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_flash_kernels_match_plain(dt, case):
    _need_card()
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_attention as fc
    c = _flash_case(case, dt)
    f32 = {k: v.float() if isinstance(v, torch.Tensor) and
           v.is_floating_point() else v for k, v in c.items()}
    extra = (c["seg_q"], c["seg_k"], c["bias"])
    args = (c["q"], c["k"], c["v"], c["scale"], c["causal"])
    args32 = (f32["q"], f32["k"], f32["v"], c["scale"], c["causal"])
    layer.reset_counts()
    out, lse = fc.flash_fwd_cuda(*args, *extra)
    delta = fa.flash_delta(c["out"], c["do"])
    bw = (c["do"], c["lse"], delta, c["scale"], c["causal"], *extra)
    dq = fc.flash_bwd_dq_cuda(c["q"], c["k"], c["v"], *bw)
    dk, dv = fc.flash_bwd_dkv_cuda(c["q"], c["k"], c["v"], *bw)
    torch.cuda.synchronize()
    assert {k: n for k, n in layer.launch_counts().items() if n} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    t_out, t_lse = fa.flash_fwd_ref(*args32, *extra)
    _flash_ok("out", out, c["out"], t_out, dt)
    torch.testing.assert_close(lse, c["lse"], rtol=1e-4, atol=1e-4)
    plain = fa.flash_bwd_ref(c["q"], c["k"], c["v"], c["out"], c["lse"],
                             c["do"], c["scale"], c["causal"], *extra)
    truth = fa.flash_bwd_ref(*args32[:3], f32["out"], c["lse"], f32["do"],
                             c["scale"], c["causal"], *extra)
    for name, g, p, t in zip(("dq", "dk", "dv"), (dq, dk, dv), plain, truth):
        _flash_ok(name, g, p, t, dt)


@pytest.mark.gpu
def test_flash_attention_op_launches_kernels_and_refuses_head_dim():
    _need_card()
    from paddle_tpu_torch.ops.flash_attention import flash_attention
    q = torch.randn(1, 64, 2, 64, device="cuda", requires_grad=True)
    layer.reset_counts()
    flash_attention(q, q, q, causal=True).sum().backward()
    torch.cuda.synchronize()
    assert {k: n for k, n in layer.launch_counts().items() if n} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(*[torch.randn(1, 8, 2, 32, device="cuda")] * 3)


# ---------------------------------------------------------- linear-CE head
# (T, H, V, chunk, ignore_index, label_smoothing): T off the 64 / 128 row
# tiles, V off the 128-column tiles, an uneven last slab (300 = 2 x 128 +
# 44, its dz scratch padded to 48 columns); then the edges of the bf16
# kernels' 128 x 256 tiles and 64-column K steps: T 300, V 513 (a last
# vocab tile and slab one column wide), H 72 (a second, partial K step);
# V 100 < 256 with H 8 (one K step, mostly zero fill); then the backward
# products' tiles (128 x 256 outputs, K 64): slabs of 200 (dx's K ends
# mid-step; the last slab 100 rows, under dw's 128, its dz scratch with
# leading dimension 104), T 1000 (dw's K ends mid-step), H 200 (under 256,
# off 64).  Row 1's label is V - 1, in the last, partial vocab tile.
LCE_CASES = [(100, 64, 300, 128, -100, 0.0), (64, 32, 97, 40, None, 0.1),
             (300, 72, 513, 256, -100, 0.0), (200, 8, 100, 64, None, 0.1),
             (1000, 200, 1100, 200, -100, 0.1)]
LCE_IDS = ["ignore-index", "smoothing", "tile-edges-ignore-index",
           "v-below-tile-h8-smoothing", "bwd-tile-edges-chunk200-h200"]
# bf16 operands take the wgmma kernels: all four with bf16 x and w; fwd,
# dz and dw (on the bf16 halves of x and dz, the split route) and dx with
# fp32 x; dw alone with fp32 w (dz_x and x bf16, dw written fp32)
LCE_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]
LCE_DTYPE_IDS = ["fp32", "bf16", "fp32x-bf16w", "bf16x-fp32w"]


@pytest.mark.gpu
@pytest.mark.parametrize("dts", LCE_DTYPES, ids=LCE_DTYPE_IDS)
@pytest.mark.parametrize("case", LCE_CASES, ids=LCE_IDS)
def test_linear_ce_kernels_match_plain(dts, case):
    """nll / lse (fp32 outputs: 1e-4 whatever the inputs' dtype, the
    products differ only in summation order), the last slab's dz, and
    dx / dw (1e-4 in fp32, 2e-2 with a bf16 operand) against the plain
    versions; one fwd launch and one dz, dx and dw launch per slab (and
    with fp32 x and bf16 w one ``linear_ce_split_x`` a forward and a
    backward call); a second forward, dz and backward call bit-identical
    to the first.  With fp32 x and bf16 w (the split route) dz comes as
    its bf16 halves, dz_hi (dz in w's dtype) and dz_lo; also nll and lse
    within 1e-4 absolute, dz_hi + dz_lo within 1e-4 |g| p + 136 x 2^-24
    |dz| elementwise (p = exp(z - lse), the part of dz an error in z
    moves; the second term the pair's 2^-17 |dz| and the few fp32
    roundings of dz = g (p - 1) at the label), which x rounded to bf16
    would miss, and dw within half a bf16 ulp of the plain fp32 dw plus
    ``chip_smoke``'s allowance (``chip_smoke.split_dw_excess``)."""
    _need_card()
    from paddle_tpu_torch.ops import fused_cross_entropy as fce
    from paddle_tpu_torch.ops.cuda import linear_ce as lc
    xdt, wdt = dts
    T, Hd, V, chunk, ignore, eps = case
    rng = np.random.default_rng(11)

    def t(*shape, scale=1.0, dt=torch.float32):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to("cuda", dt)
    x, w, g = t(T, Hd, dt=xdt), t(V, Hd, scale=0.3, dt=wdt), t(T)
    lab = torch.from_numpy(rng.integers(0, V, T)).cuda()
    lab[1] = V - 1
    if ignore is not None:
        lab[::7] = ignore
        g = torch.where(lab != ignore, g, 0.0)
    kw = dict(label_smoothing=eps)
    layer.reset_counts()
    nll, lse = lc.linear_ce_fwd_cuda(x, w, lab, ignore_index=ignore, **kw)
    dx, dw = lc.linear_ce_bwd_cuda(x, w, lab, lse, g, chunk=chunk, **kw)
    torch.cuda.synchronize()
    slabs = -(-V // chunk)
    split = (xdt, wdt) == (torch.float32, torch.bfloat16)
    assert {k: n for k, n in layer.launch_counts().items() if n} == {
        "linear_ce_fwd": 1, "linear_ce_dz": slabs, "linear_ce_dx": slabs,
        "linear_ce_dw": slabs, **({"linear_ce_split_x": 2} if split else {})}
    # a second call on the same inputs: the same bits (the forward folds
    # its vocab tiles' partials in a fixed order)
    nll2, lse2 = lc.linear_ce_fwd_cuda(x, w, lab, ignore_index=ignore, **kw)
    assert torch.equal(nll, nll2) and torch.equal(lse, lse2)
    dx2, dw2 = lc.linear_ce_bwd_cuda(x, w, lab, lse, g, chunk=chunk, **kw)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    nll_p, lse_p = fce.lce_fwd_ref(x, w, lab, chunk=chunk,
                                   ignore_index=ignore, **kw)
    torch.testing.assert_close(nll, nll_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
    tol = TOL[torch.float32 if xdt == wdt == torch.float32
              else torch.bfloat16]
    c0 = (slabs - 1) * chunk                # the uneven last slab
    dz_w, dz_x = lc.linear_ce_dz_cuda(x, w, lab, lse_p, g, c0, V - c0, **kw)
    dz_w2, dz_x2 = lc.linear_ce_dz_cuda(x, w, lab, lse_p, g, c0, V - c0,
                                        **kw)
    assert torch.equal(dz_w, dz_w2) and torch.equal(dz_x, dz_x2)
    dz_p = fce.lce_dz_ref(x, w[c0:], lab, lse_p, g, c0, V, eps)
    if split:
        assert dz_x.shape == (2, T, V - c0) and dz_x.dtype == torch.bfloat16
        assert torch.equal(dz_x[0], dz_w)
        dz_x = dz_x[0].float() + dz_x[1].float()
    assert dz_w.dtype == wdt and dz_x.dtype == xdt
    torch.testing.assert_close(dz_w.float(), dz_p.to(wdt).float(), **tol)
    torch.testing.assert_close(dz_x.float(), dz_p.to(xdt).float(), **tol)
    if split:
        assert float((nll - nll_p).abs().max()) <= 1e-4
        assert float((lse - lse_p).abs().max()) <= 1e-4
        p = (x @ w[c0:].float().t() - lse_p[:, None]).exp()
        lim = 1e-4 * g.abs()[:, None] * p + 136 * 2.0 ** -24 * dz_p.abs()
        assert bool(((dz_x - dz_p).abs() <= lim).all())
    dx_p, dw_p = fce.lce_bwd_ref(x, w, lab, lse_p, g, chunk=chunk, **kw)
    assert dx.dtype == xdt and dw.dtype == wdt
    torch.testing.assert_close(dx.float(), dx_p.float(), **tol)
    torch.testing.assert_close(dw.float(), dw_p.float(), **tol)
    if split:
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        import chip_smoke as cs
        _, dw_t = fce.lce_bwd_ref(x, w.float(), lab, lse_p, g, chunk=chunk,
                                  **kw)
        case = ("gpu", T, Hd, V, chunk, "float32", "bfloat16", ignore, eps)
        assert cs.split_dw_excess(case, x, w, lab, lse_p, g, dw,
                                  dw_t)["kernels"] <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("T,H", [(1, 8), (300, 72), (1000, 200)])
def test_linear_ce_split_x_equals_plain_bit_for_bit(T, H):
    """The split route's pre-pass: ``[bf16(x), bf16(x - bf16(x))]`` equal
    to its plain version bit for bit, on values spread over 60 binades."""
    _need_card()
    from paddle_tpu_torch.ops import fused_cross_entropy as fce
    from paddle_tpu_torch.ops.cuda import linear_ce as lc
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((T, H)) * np.exp2(
        rng.integers(-30, 30, (T, H)))).astype(np.float32)).cuda()
    layer.reset_counts()
    xs = lc.linear_ce_split_x_cuda(x)
    torch.cuda.synchronize()
    assert layer.launch_counts()["linear_ce_split_x"] == 1
    assert torch.equal(xs, fce.lce_split_x_ref(x))


@pytest.mark.gpu
def test_linear_cross_entropy_op_launches_kernels_and_refuses_widths():
    """The op on the card: the [H, V] layout through the kernels (grads in
    that layout), and a hidden size the kernels do not take raises."""
    _need_card()
    from paddle_tpu_torch.ops.fused_cross_entropy import (
        linear_cross_entropy, lce_bwd_ref, lce_fwd_ref)
    x = torch.randn(2, 50, 64, device="cuda", requires_grad=True)
    head = (0.3 * torch.randn(64, 700, device="cuda")).requires_grad_(True)
    lab = torch.randint(0, 700, (2, 50), device="cuda")
    layer.reset_counts()
    linear_cross_entropy(x, head, lab, w_layout="hv", chunk=256).sum() \
        .backward()
    torch.cuda.synchronize()
    assert {k: n for k, n in layer.launch_counts().items() if n} == {
        "linear_ce_fwd": 1, "linear_ce_dz": 3, "linear_ce_dx": 3,
        "linear_ce_dw": 3}
    x2, w = x.detach().reshape(100, 64), head.detach().t()
    _, lse = lce_fwd_ref(x2, w, lab.reshape(-1), chunk=256)
    dx, dw = lce_bwd_ref(x2, w, lab.reshape(-1), lse, torch.ones(
        100, device="cuda"), chunk=256)
    torch.testing.assert_close(x.grad.reshape(100, 64), dx, **TOL[
        torch.float32])
    torch.testing.assert_close(head.grad, dw.t(), **TOL[torch.float32])
    with pytest.raises(ValueError, match="multiple of 8"):
        linear_cross_entropy(torch.randn(4, 12, device="cuda"),
                             torch.randn(10, 12, device="cuda"),
                             torch.zeros(4, dtype=torch.long, device="cuda"))


# ------------------------------------------------------ generation kernels
# (label, B, Hq, Hkv, D, T, lengths, layer slice of an [L, B, T, H, D] cache)
DATTN_CASES = [
    ("gqa D64 T600 ragged", 3, 8, 2, 64, 600, (1, 600, 37), False),
    ("mha D128 length 1", 2, 4, 4, 128, 40, (40, 1), False),
    ("cache[l] slice", 2, 8, 4, 128, 300, (300, 129), True),
    # a length-0 row (every score masked: the mean of v over the T rows,
    # as in the plain version), four 512-row blocks on a cluster of 8,
    # and the largest group (G 8) at D 64
    ("length 0 row", 3, 8, 4, 128, 300, (0, 300, 17), False),
    ("T 2048 four blocks", 2, 8, 8, 128, 2048, (2048, 1500), False),
    ("G 8 D64", 2, 16, 2, 64, 700, (700, 3), False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("case", DATTN_CASES, ids=[c[0] for c in
                                                   DATTN_CASES])
def test_decode_attention_kernel_matches_plain(dt, case):
    """One launch per call, against the plain version (which rounds p to
    the cache's dtype as the kernel does); the cache read in place; a
    second call bit-identical to the first."""
    _need_card()
    from paddle_tpu_torch.ops import decode_attention as tda
    _, B, Hq, Hkv, D, T, lengths, sliced = case
    rng = np.random.default_rng(21)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dt)
    q = t(B, Hq, D)
    if sliced:
        kc, vc = t(3, B, T, Hkv, D)[1], t(3, B, T, Hkv, D)[2]
    else:
        kc, vc = t(B, T, Hkv, D), t(B, T, Hkv, D)
    lt = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    outs = []
    for _ in range(2):
        layer.reset_counts()
        outs.append(tda.decode_attention(q, kc, vc, lt))
        torch.cuda.synchronize()
        assert {k: n for k, n in layer.launch_counts().items() if n} == {
            "decode_attention": 1}
    torch.testing.assert_close(outs[0].float(), tda.decode_attention_ref(
        q, kc, vc, lt).float(), **TOL[dt])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_decode_attention_kernel_reads_a_head_major_cache(dt):
    """Paddle's MMHA cache ``[2, B, H, T_max, D]`` through the view
    ``cache[0].transpose(1, 2)`` (head stride T D): one launch, against the
    plain version on the same view and on a contiguous copy, with a
    length-0 row and rows past one 512-row block."""
    _need_card()
    from paddle_tpu_torch.ops import decode_attention as tda
    B, Hh, T, Dh = 4, 4, 700, 128
    rng = np.random.default_rng(22)
    cache = torch.from_numpy(rng.standard_normal(
        (2, B, Hh, T, Dh)).astype(np.float32)).to("cuda", dt)
    q = torch.from_numpy(rng.standard_normal((B, Hh, Dh)).astype(
        np.float32)).to("cuda", dt)
    lt = torch.tensor([700, 37, 0, 517], dtype=torch.int32, device="cuda")
    kc, vc = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    layer.reset_counts()
    got = tda.decode_attention(q, kc, vc, lt)
    torch.cuda.synchronize()
    assert {k: n for k, n in layer.launch_counts().items() if n} == {
        "decode_attention": 1}
    torch.testing.assert_close(got.float(), tda.decode_attention_ref(
        q, kc, vc, lt).float(), **TOL[dt])
    torch.testing.assert_close(got.float(), tda.decode_attention_ref(
        q, kc.contiguous(), vc.contiguous(), lt).float(), **TOL[dt])


@pytest.mark.gpu
def test_masked_multihead_attention_launches_kernel_3_on_the_callers_cache():
    """MMHA on a bf16 ``[2, B, H, T, D]`` CUDA cache: one decode_attention
    launch and nothing else, this step's k / v written into the caller's
    cache in place and that very tensor returned; output and cache equal
    the same call on the CPU (the plain version), with a length-0 row."""
    _need_card()
    from paddle_tpu_torch.incubate.nn import functional as IF
    dt = torch.bfloat16
    B, Hh, T, Dh = 2, 4, 16, 128
    rng = np.random.default_rng(23)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dt)
    x, bias, cache = t(B, 3 * Hh * Dh), t(3 * Hh * Dh), t(2, B, Hh, T, Dh)
    lens = torch.tensor([9, 0], dtype=torch.int32)
    want, want_cache = IF.masked_multihead_attention(
        x, cache.clone(), bias=bias, sequence_lengths=lens)
    given = cache.cuda()
    layer.reset_counts()
    out, back = IF.masked_multihead_attention(
        x.cuda(), given, bias=bias.cuda(), sequence_lengths=lens.cuda())
    torch.cuda.synchronize()
    assert {k: n for k, n in layer.launch_counts().items() if n} == {
        "decode_attention": 1}
    assert back is given
    assert out.dtype == dt and out.shape == (B, Hh * Dh)
    _close(out, want, dt)
    _close(given, want_cache, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("qdt,cdt",[(torch.float32, torch.bfloat16),
                                     (torch.float16, torch.float16)],
                         ids=["fp32-q-bf16-cache", "fp16"])
def test_decode_attention_kernel_refuses_other_dtypes(qdt, cdt):
    """No kernel instance for a q of another dtype than the cache's, nor
    for fp16: the call raises, with no plain-version fallback."""
    _need_card()
    from paddle_tpu_torch.ops import decode_attention as tda
    q = torch.zeros(2, 4, 64, device="cuda", dtype=qdt)
    kc = torch.zeros(2, 16, 4, 64, device="cuda", dtype=cdt)
    lt = torch.full((2,), 16, dtype=torch.int32, device="cuda")
    layer.reset_counts()
    with pytest.raises(NotImplementedError, match="queue 2 A item 6"):
        tda.decode_attention(q, kc, kc, lt)
    assert not any(layer.launch_counts().values())


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("M,H", [(1, 4096), (4, 4096), (256, 4096),
                                 (4, 1001), (4, 4100)],
                         ids=["M1", "M4", "M256", "H1001", "H4100"])
def test_rms_norm_rows_kernel_matches_plain(dt, M, H):
    """The chain's norm alone: the vector path at H 4096 (decode, one
    prefill chunk); the scalar path at H 1001, off the 16-byte vectors,
    and at H 4100 in bf16 (fp32 takes 4-element vectors there); one
    launch a call."""
    _need_card()
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((M, H)).astype(
        np.float32)).to("cuda", dt)
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(H)).astype(
        np.float32)).to("cuda", dt)
    layer.reset_counts()
    got = K.rms_norm_rows_cuda(x, w, 1e-5)
    torch.cuda.synchronize()
    assert {k: n for k, n in layer.launch_counts().items() if n} == {
        "rms_norm_rows": 1}
    _close(got, K.rms_norm_rows_ref(x, w, 1e-5), dt)


# (width, M, K, N, group_size): decode and prefill row counts, per
# channel, groups of 64 (dequantized tile) and 128, K off the 8-column
# loads (x copied to the padded layout), odd K for int4, and int4 groups
# not aligned to the nibble planes (half 151: the tile rule)
WO_CASES = [("int8", 8, 256, 64, -1), ("int8", 40, 300, 48, 128),
            ("int8", 1, 256, 32, 64), ("int4", 8, 512, 64, -1),
            ("int4", 100, 512, 144, 128), ("int4", 3, 255, 32, 64),
            ("int4", 40, 301, 32, 128),
            # the prefill kernel's edges: its smallest M; M and N off the
            # 256-row and 128-channel tiles; a llama down projection in int4
            # with groups of 128 inside each nibble plane (half 5504, the
            # post rule); int8 groups of 64 (the tile rule)
            ("int8", 17, 256, 64, -1), ("int8", 257, 300, 400, -1),
            ("int4", 129, 11008, 4096, 128), ("int8", 200, 512, 144, 64),
            # the decode kernel's edges: M 1, 8, 9 and 16 (its 8- and 16-row
            # x tiles), N under one 128-channel tile (48) and off it
            # (11008), an odd int4 K, groups of 64 (tile) and 128 (post) at
            # M 8, and K long enough to split over a cluster
            ("int8", 1, 520, 48, -1), ("int8", 9, 4096, 48, -1),
            ("int8", 16, 2048, 11008, -1), ("int4", 8, 2048, 11008, -1),
            ("int4", 1, 4095, 48, -1), ("int4", 16, 4095, 144, 64),
            ("int8", 8, 1024, 144, 64), ("int8", 8, 1024, 144, 128),
            ("int4", 8, 1024, 144, 64), ("int4", 8, 1024, 144, 128),
            ("int4", 9, 11008, 4096, 128)]
WO_IDS = [f"{w}-M{m}-K{k}-N{n}-g{g}" for w, m, k, n, g in WO_CASES]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("case", WO_CASES, ids=WO_IDS)
def test_weight_only_kernels_match_plain(dt, case):
    """The regime's kernel launches once and matches the plain version."""
    _need_card()
    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops import quant_linear as tql
    width, M, K, N, gs = case
    rng = np.random.default_rng(22)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.05).astype(
        np.float32))
    codes, scale = weight_quantize(w, f"weight_only_{width}", group_size=gs)
    codes, scale = codes.cuda(), scale.cuda()
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)) \
        .to("cuda", dt)
    fn, ref = ((tql.weight_only_matmul_int4, tql.weight_only_matmul_int4_ref)
               if width == "int4" else
               (tql.weight_only_matmul, tql.weight_only_matmul_ref))
    layer.reset_counts()
    got = fn(x, codes, scale, group_size=gs)
    torch.cuda.synchronize()
    name = ("wo_f32" if dt == torch.float32 else
            f"wo_{width}_{'small_m' if M <= 16 else 'tiled'}")
    assert {k: n for k, n in layer.launch_counts().items() if n} == {name: 1}
    assert got.dtype == dt and got.shape == (M, N)
    torch.testing.assert_close(got.float(), ref(x, codes, scale,
                                                group_size=gs).float(),
                               **TOL[dt])


@pytest.mark.gpu
@pytest.mark.parametrize("case", [("int8", 8, 4096, 4096, -1),
                                  ("int4", 16, 11008, 4096, 128),
                                  ("int4", 3, 4096, 11008, 64)],
                         ids=["int8-M8", "int4-M16-g128", "int4-M3-g64"])
def test_weight_only_decode_calls_are_bit_identical(case):
    """The decode kernel's K splits fold in a fixed order: two calls on the
    same inputs give the same bits."""
    _need_card()
    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops import quant_linear as tql
    width, M, K, N, gs = case
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    w = 0.02 * torch.randn(K, N, device="cuda", generator=gen)
    codes, scale = weight_quantize(w, f"weight_only_{width}", group_size=gs)
    x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
    fn = (tql.weight_only_matmul_int4 if width == "int4" else
          tql.weight_only_matmul)
    layer.reset_counts()
    first = fn(x, codes, scale, group_size=gs)
    second = fn(x, codes, scale, group_size=gs)
    torch.cuda.synchronize()
    assert layer.launch_counts()[f"wo_{width}_small_m"] == 2
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_weight_only_kernels_refuse_widths():
    _need_card()
    from paddle_tpu_torch.ops import quant_linear as tql
    x = torch.zeros(4, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        tql.weight_only_matmul(x, torch.zeros(64, 24, dtype=torch.int8,
                                              device="cuda"),
                               torch.ones(24, device="cuda"))


# ------------------------------------------------------- eager-path kernels
# (rows, H): 3 rows, H 1000 (16-byte chunks, a ragged last warp), H 1001
# and 77 (not a multiple of the 16-byte chunk: the scalar path), the GPT
# width and a long row (8 chunks a thread)
NORM_CASES = [(3, 1000), (5, 1001), (16, 77), (64, 768), (4, 11008)]
NORM_IDS = [f"R{r}-H{h}" for r, h in NORM_CASES]


def _norm_inputs(R, H, dt, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                                .astype(np.float32)).to("cuda", dt)
    return (t(R, H, shift=0.3), t(R, H), t(H, scale=0.1),
            t(H, scale=0.1, shift=1.0), t(H, scale=0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("case", NORM_CASES, ids=NORM_IDS)
def test_norm_kernels_match_plain(dt, case):
    """Each op launches its kernel once; outputs and fp32 statistics match
    the plain versions; bf16 gains go in as fp32 and fp32 ones too."""
    _need_card()
    from paddle_tpu_torch.ops import norms as tn
    from paddle_tpu_torch.ops.cuda import norms as cn
    R, H = case
    x, res, bias, w, b = _norm_inputs(R, H, dt, 23)
    for fn, ref, args, name in (
            (cn.rms_norm_fwd_cuda, tn.rms_norm_ref, (x, w), "rms_norm_fwd"),
            (cn.layer_norm_fwd_cuda, tn.layer_norm_ref, (x, w, b),
             "layer_norm_fwd"),
            (cn.bias_residual_ln_fwd_cuda, tn.bias_residual_ln_ref,
             (x, res, bias, w.float(), b.float()), "bias_residual_ln_fwd")):
        layer.reset_counts()
        got = fn(*args, 1e-5)
        torch.cuda.synchronize()
        assert {k: n for k, n in layer.launch_counts().items() if n} == {
            name: 1}
        for g_, r_ in zip(got, ref(*args, 1e-5)):
            assert g_.dtype == r_.dtype and g_.shape == r_.shape
            tol = TOL[torch.float32 if r_.dtype == torch.float32 else dt]
            torch.testing.assert_close(g_.float(), r_.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("R,H", [(8192, 4096), (300, 4097), (3, 4096)],
                         ids=["llama", "odd-H", "3-rows"])
def test_rms_norm_fwd_row_loop_matches_plain(dt, R, H):
    """The persistent row loop at the eager Llama step's rows, at an odd H
    (the scalar loads) and with fewer rows than the grid keeps resident:
    out and the fp32 inv against the plain version, one launch, a second
    call bit-identical."""
    _need_card()
    from paddle_tpu_torch.ops import norms as tn
    from paddle_tpu_torch.ops.cuda import norms as cn
    x, _, _, w, _ = _norm_inputs(R, H, dt, 24)
    got = _once_bitwise(lambda: torch.cat([o.float().reshape(-1) for o in
                                           cn.rms_norm_fwd_cuda(x, w, 1e-5)]),
                        "rms_norm_fwd")
    out, inv = tn.rms_norm_ref(x, w, 1e-5)
    _close(got[:R * H].reshape(R, H), out, dt)
    torch.testing.assert_close(got[R * H:], inv, **TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("n", [1, 7, 4096, 8 * 11008 + 3])
def test_swiglu_kernel_matches_plain(dt, n):
    _need_card()
    from paddle_tpu_torch.ops import fused as tf
    from paddle_tpu_torch.ops.cuda import fused as cf
    rng = np.random.default_rng(24)
    x, y = (torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 3)
            .to("cuda", dt) for _ in range(2))
    layer.reset_counts()
    got = cf.swiglu_fwd_cuda(x, y)
    torch.cuda.synchronize()
    assert {k: c for k, c in layer.launch_counts().items() if c} == {
        "swiglu_fwd": 1}
    torch.testing.assert_close(got.float(), tf.swiglu_ref(x, y).float(),
                               **TOL[dt])
    # an unaligned view takes the scalar path
    got = cf.swiglu_fwd_cuda(x[1:], y[1:]) if n > 1 else got
    torch.testing.assert_close(got.float(), tf.swiglu_ref(
        x[1:] if n > 1 else x, y[1:] if n > 1 else y).float(), **TOL[dt])


@pytest.mark.gpu
def test_eager_ops_launch_kernels_and_differentiate():
    """The ops' autograd Functions run the kernels forward on CUDA and the
    JAX VJPs backward; the grads match the plain path's on the CPU."""
    _need_card()
    from paddle_tpu_torch.ops import fused as tf
    from paddle_tpu_torch.ops import norms as tn
    x, res, bias, w, b = _norm_inputs(6, 96, torch.float32, 25)
    calls = {
        "rms_norm_fwd": lambda a: tn.rms_norm(a[0], a[3], 1e-5),
        "layer_norm_fwd": lambda a: tn.layer_norm(a[0], a[3], a[4], 1e-5),
        "bias_residual_ln_fwd": lambda a: sum(
            tn.fused_bias_dropout_residual_layer_norm(
                a[0], a[1], a[2], a[3], a[4], 0.0, 1e-5, False)),
        "swiglu_fwd": lambda a: tf.swiglu(a[0], a[1])}
    for name, fn in calls.items():
        grads = []
        for dev in ("cuda", "cpu"):
            args = [t.detach().to(dev).requires_grad_()
                    for t in (x, res, bias, w, b)]
            layer.reset_counts()
            (fn(args) * torch.linspace(-1, 1, 96, device=dev)).sum() \
                .backward()
            if dev == "cuda":
                torch.cuda.synchronize()
                assert {k: c for k, c in layer.launch_counts().items()
                        if c} == {name: 1}
            grads.append([a.grad for a in args])
        for g_cuda, g_cpu in zip(*grads):
            if g_cpu is not None:
                torch.testing.assert_close(g_cuda.cpu(), g_cpu,
                                           **TOL[torch.float32])


# ------------------------------------------------- the incubate fused API
def _cpu_args():
    x = torch.zeros(2, 4, 2, 8)
    return {
        "rope_fwd_cuda": ("rope", lambda m: m.rope_fwd_cuda(
            x, torch.zeros(4, 8), torch.zeros(4, 8))),
        "softmax_mask_fwd_cuda": ("fused", lambda m: m.softmax_mask_fwd_cuda(
            x, torch.zeros(8))),
        "bias_act_fwd_cuda": ("fused", lambda m: m.bias_act_fwd_cuda(
            x, torch.zeros(8), "gelu")),
        "dropout_add_fwd_cuda": ("fused", lambda m: m.dropout_add_fwd_cuda(
            x, x, 0.1, True, torch.zeros(1, dtype=torch.int64))),
    }


@pytest.mark.parametrize("name", sorted(_cpu_args()))
def test_fused_wrappers_refuse_cpu_tensors(name):
    """The kernels' wrappers take CUDA tensors only: a CPU tensor raises
    before anything is built (no fallback to the plain version)."""
    import importlib
    mod, call = _cpu_args()[name]
    m = importlib.import_module(f"paddle_tpu_torch.ops.cuda.{mod}")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        call(m)


ROPE_CASES = [(2, 8, 3, 16), (1, 5, 2, 6), (2, 64, 4, 128), (1, 3, 1, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("shape", ROPE_CASES,
                         ids=[f"D{s[-1]}-H{s[2]}" for s in ROPE_CASES])
def test_rope_kernel_matches_plain(dt, shape):
    """Forward (sign 1) and the VJP's inverse rotation (sign -1), bf16
    tables upcast; any even D (6 and 2: the scalar path)."""
    _need_card()
    from paddle_tpu_torch.ops import rope as tr
    from paddle_tpu_torch.ops.cuda import rope as cr
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        "cuda", dt)
    cos, sin = tr.rope_cos_sin(shape[1], shape[-1], device="cuda",
                               dtype=dt)
    for sign in (1.0, -1.0):
        layer.reset_counts()
        got = cr.rope_fwd_cuda(x, cos, sin, sign)
        torch.cuda.synchronize()
        assert {k: c for k, c in layer.launch_counts().items() if c} == {
            "rope_fwd": 1}
        torch.testing.assert_close(got.float(),
                                   tr.rope_ref(x, cos, sin, sign).float(),
                                   **TOL[dt])


SOFTMAX_CASES = [("S7", (2, 3, 5, 7), (2, 1, 5, 7)),
                 ("S1", (4, 3, 1), (1,)),
                 ("S300", (2, 3, 300), (300,)),
                 ("S1000", (2, 3, 7, 1000), (2, 1, 1, 1000)),
                 ("S5000-row-mask", (3, 2, 5000), (3, 1, 5000)),
                 ("S128-col-broadcast", (2, 4, 128), (2, 4, 1))]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("mdt", DTYPES, ids=["mask-fp32", "mask-bf16"])
@pytest.mark.parametrize("case", SOFTMAX_CASES,
                         ids=[c[0] for c in SOFTMAX_CASES])
def test_softmax_mask_kernel_matches_plain(dt, mdt, case):
    """The mask read in place through broadcast strides (stride 0 on its
    broadcast dims, or along the row); an all -inf row gives NaN."""
    _need_card()
    from paddle_tpu_torch.ops import fused as tf
    from paddle_tpu_torch.ops.cuda import fused as cf
    _, xs, ms = case
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32) * 3).to(
        "cuda", dt)
    m = torch.from_numpy(np.where(rng.random(ms) < 0.2, -np.inf, 0.0)
                         .astype(np.float32)).to("cuda", mdt)
    m.view(-1)[0] = 0.0
    layer.reset_counts()
    got = cf.softmax_mask_fwd_cuda(x, m)
    torch.cuda.synchronize()
    assert {k: c for k, c in layer.launch_counts().items() if c} == {
        "softmax_mask_fwd": 1}
    ref = tf.softmax_mask_ref(x, m)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    ok = ~torch.isnan(ref)
    torch.testing.assert_close(got[ok].float(), ref[ok].float(), **TOL[dt])


# the register path's row widths (S 1..1000: 8 or 32 lanes a row, one to
# eight chunks a lane) and the long rows (S 5000); R off the rows a warp
# takes; masks broadcast over heads, over query rows, over both, along the
# row (one value a row), full, and strided (a slice of a wider mask: its
# row stride off the 16-byte chunks); (label, x shape, mask shape, extra
# mask columns sliced off)
SOFTMAX_WARP_CASES = [
    ("S1-heads", (4, 3, 1), (4, 1, 1), 0),
    ("S7-heads", (2, 3, 5, 7), (2, 1, 5, 7), 0),
    ("S127-heads", (3, 5, 9, 127), (3, 1, 9, 127), 0),
    ("S128-heads", (2, 12, 17, 128), (2, 1, 17, 128), 0),
    ("S129-rows", (2, 3, 7, 129), (2, 3, 1, 129), 0),
    ("S1000-heads-rows", (2, 3, 7, 1000), (2, 1, 1, 1000), 0),
    ("S5000-heads", (3, 2, 5000), (3, 1, 5000), 0),
    ("S128-columns", (2, 4, 5, 128), (2, 4, 5, 1), 0),
    ("S128-full", (3, 5, 128), (3, 5, 128), 0),
    ("S127-full", (2, 3, 7, 127), (2, 3, 7, 127), 0),
    ("S128-heads-strided", (2, 3, 6, 128), (2, 1, 6, 128), 3),
    ("S64-full-strided", (4, 6, 64), (4, 6, 64), 6)]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("mdt", DTYPES, ids=["mask-fp32", "mask-bf16"])
@pytest.mark.parametrize("case", SOFTMAX_WARP_CASES,
                         ids=[c[0] for c in SOFTMAX_WARP_CASES])
def test_softmax_mask_rows_match_plain_and_repeat(dt, mdt, case):
    """Every row width and mask layout within tolerance of the plain
    version (all -inf rows NaN in both); each call one launch, a second
    call bit-identical."""
    _need_card()
    from paddle_tpu_torch.ops import fused as tf
    from paddle_tpu_torch.ops.cuda import fused as cf
    _, xs, ms, extra = case
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32) * 3).to(
        "cuda", dt)
    wide = ms[:-1] + (ms[-1] + extra,)
    m = torch.from_numpy(np.where(rng.random(wide) < 0.2, -np.inf, 0.0)
                         .astype(np.float32)).to("cuda", mdt)
    m.view(-1)[0] = 0.0
    m = m[..., :ms[-1]]
    assert m.is_contiguous() == (extra == 0)
    outs = []
    for _ in range(2):
        layer.reset_counts()
        outs.append(cf.softmax_mask_fwd_cuda(x, m))
        torch.cuda.synchronize()
        assert {k: c for k, c in layer.launch_counts().items() if c} == {
            "softmax_mask_fwd": 1}
    assert torch.equal(_bits(outs[0]), _bits(outs[1]))
    got, ref = outs[0], tf.softmax_mask_ref(x, m)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    ok = ~torch.isnan(ref)
    torch.testing.assert_close(got[ok].float(), ref[ok].float(), **TOL[dt])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "tanh", "sigmoid"])
@pytest.mark.parametrize("H", [3072, 1001])
def test_bias_act_kernel_matches_plain(dt, act, H):
    _need_card()
    from paddle_tpu_torch.ops import fused as tf
    from paddle_tpu_torch.ops.cuda import fused as cf
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.standard_normal((7, H)).astype(np.float32) * 3
                         ).to("cuda", dt)
    bias = torch.from_numpy(rng.standard_normal(H).astype(np.float32)).to(
        "cuda", dt)
    layer.reset_counts()
    got = cf.bias_act_fwd_cuda(x, bias, act)
    torch.cuda.synchronize()
    assert {k: c for k, c in layer.launch_counts().items() if c} == {
        "bias_act_fwd": 1}
    torch.testing.assert_close(got.float(),
                               tf.bias_act_ref(x, bias, act).float(),
                               **TOL[dt])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("n", [1, 7, 4096 * 768, 4096 * 768 + 5])
def test_dropout_add_kernel_equals_plain_bit_for_bit(dt, n):
    """Training at p 0.1 under one seed, and the plain add: the kernel's
    output equals its plain version's exactly; an unaligned view takes
    the scalar path."""
    _need_card()
    from paddle_tpu_torch.ops import fused as tf
    from paddle_tpu_torch.ops.cuda import fused as cf
    rng = np.random.default_rng(34)
    x, y = (torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32))
            .to("cuda", dt) for _ in range(2))
    seed = torch.tensor([987654321], dtype=torch.int64, device="cuda")
    for xs, ys in ((x[:n], y[:n]), (x[1:], y[1:])):
        for drop in (True, False):
            layer.reset_counts()
            got = cf.dropout_add_fwd_cuda(xs, ys, 0.1, drop, seed)
            torch.cuda.synchronize()
            assert {k: c for k, c in layer.launch_counts().items() if c} == {
                "dropout_add_fwd": 1}
            assert torch.equal(got, tf.dropout_add_ref(xs, ys, 0.1, drop,
                                                       seed))


@pytest.mark.gpu
def test_fused_wrappers_refuse_bad_arguments():
    _need_card()
    from paddle_tpu_torch.ops.cuda import fused as cf
    from paddle_tpu_torch.ops.cuda import rope as cr
    x = torch.zeros(2, 4, 2, 8, device="cuda")
    seed = torch.zeros(1, dtype=torch.int64, device="cuda")
    for call, match in (
            (lambda: cr.rope_fwd_cuda(torch.zeros(2, 4, 2, 7, device="cuda"),
                                      torch.zeros(4, 7, device="cuda"),
                                      torch.zeros(4, 7, device="cuda")),
             "even"),
            (lambda: cr.rope_fwd_cuda(x, torch.zeros(5, 8, device="cuda"),
                                      torch.zeros(5, 8, device="cuda")),
             r"\[4, 8\]"),
            (lambda: cr.rope_fwd_cuda(x.half(), torch.zeros(4, 8).cuda(),
                                      torch.zeros(4, 8).cuda()), "bfloat16"),
            (lambda: cf.softmax_mask_fwd_cuda(x, torch.zeros(3, device="cuda")
                                              ), "broadcast"),
            (lambda: cf.bias_act_fwd_cuda(x, torch.zeros(8, device="cuda"),
                                          "elu"), "unknown activation"),
            (lambda: cf.bias_act_fwd_cuda(x, torch.zeros(4, device="cuda")),
             r"\[8\]"),
            (lambda: cf.dropout_add_fwd_cuda(x, x[:1], 0.1, True, seed),
             "must match"),
            (lambda: cf.dropout_add_fwd_cuda(x, x, 0.1, True, 5),
             "seed")):
        with pytest.raises((ValueError, TypeError), match=match):
            call()


@pytest.mark.gpu
def test_incubate_ops_launch_kernels_and_rope_differentiates():
    """The ops run the kernels on CUDA: RoPE forward and backward (sign
    -1) launch rope_fwd twice each for q and k and match the CPU path's
    grads; the three forward-only ops raise in backward."""
    _need_card()
    from paddle_tpu_torch.ops import fused as tf
    from paddle_tpu_torch.ops import rope as tr
    rng = np.random.default_rng(35)
    q, k = (torch.from_numpy(rng.standard_normal((2, 8, 3, 16)).astype(
        np.float32)) for _ in range(2))
    grads = []
    for dev in ("cuda", "cpu"):
        qd, kd = (t.to(dev).requires_grad_() for t in (q, k))
        layer.reset_counts()
        oq, ok, _ = tr.fused_rope(qd, kd)
        (oq * 2 + ok).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert {n: c for n, c in layer.launch_counts().items() if c} == {
                "rope_fwd": 4}
        grads.append((qd.grad.cpu(), kd.grad.cpu()))
    for g_cuda, g_cpu in zip(*grads):
        torch.testing.assert_close(g_cuda, g_cpu, **TOL[torch.float32])
    t = torch.ones(4, 8, device="cuda", requires_grad=True)
    for out in (tf.fused_softmax_mask(t, torch.zeros(8, device="cuda")),
                tf.fused_bias_act(t, torch.zeros(8, device="cuda"), "relu"),
                tf.fused_dropout_add(t, t.detach(), 0.0, False)):
        with pytest.raises(NotImplementedError, match="has no gradient"):
            out.sum().backward()


# ------------------------------------------------------------- GPT layer
# a GPT layer at the file's widths: H 64, 2 heads of D 32 (fused qkv: one
# q head a kv head), F 96
GPT_HEADS = H // D


def _gpt_spec():
    return tdb.DecodeBlockSpec(hidden=H, num_heads=GPT_HEADS,
                               kv_heads=GPT_HEADS, head_dim=D, block_size=BS,
                               norm="ln", activation="gelu", rope=False,
                               fused_qkv=True, bias=True)


def _gpt_case(dt, dev, seed=31):
    """``_decode_case``'s tables and rows with a GPT layer and its pools."""
    from paddle_tpu_torch.models.gpt import GPTConfig, block_shapes
    c = _decode_case(dt, dev, seed)
    rng = np.random.default_rng(seed + 1)
    shapes = block_shapes(GPTConfig(hidden_size=H, num_heads=GPT_HEADS,
                                    intermediate_size=F))

    def t(*shape, scale=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev, dt)
    lp = {n: t(*s) + (1 if n.startswith("ln") and n.endswith("_w") else 0)
          for n, s in shapes.items()}
    pools = {n: t(NB, BS, GPT_HEADS, D, scale=1.0)
             for n in ("pool_k", "pool_v")}
    return dict(c, lp=lp, cos=None, sin=None, **pools)


def test_gpt_plain_versions_compose_to_the_op():
    """CPU: the GPT chain of per-kernel plain versions (the LayerNorm rows,
    the qkv product with its bias split per head, the unrotated K / V
    write, the attention, the bias, GELU and residual epilogues) is the
    op's plain version."""
    c, spec = _gpt_case(torch.float32, "cpu"), _gpt_spec()
    lp, eps = c["lp"], spec.eps
    pk, pv = c["pool_k"].clone(), c["pool_v"].clone()
    y = K.layer_norm_rows_ref(c["x"], lp["ln1_w"], lp["ln1_b"], eps)
    q, k, v = K.qkv_split_ref(K.gemm_xw_ref(y, lp["qkv_w"],
                                            bias=lp["qkv_b"]), D)
    q, k = K.rope_kv_write_ref(q, k, v, None, None, pk, pv, head_dim=D,
                               block_table=c["bt"], lengths=c["lengths"])
    attn = K.paged_attention_ref(q, pk, pv, block_table=c["bt"],
                                 lengths=c["lengths"])
    xm = K.gemm_xw_ref(attn, lp["proj_w"], bias=lp["proj_b"],
                       residual=c["x"])
    y2 = K.layer_norm_rows_ref(xm, lp["ln2_w"], lp["ln2_b"], eps)
    h = K.gemm_xw_ref(y2, lp["fc1_w"], bias=lp["fc1_b"], gelu=True)
    got = K.gemm_xw_ref(h, lp["fc2_w"], bias=lp["fc2_b"], residual=xm)
    ref = tdb.decode_block_ref(c["x"], lp, c["pool_k"].clone(),
                               c["pool_v"].clone(), c["bt"], c["lengths"],
                               None, None, spec=spec)
    for g, r in zip((got, pk, pv), ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


# the quantized GPT layer: (weight width or None, group size, int8 pools)
GPT_QUANT = [("int8", -1, True), ("int4", -1, False), ("int8", 64, True),
             (None, -1, True)]
GPT_QIDS = ["int8-kv8", "int4", "int8g64-kv8", "bf16w-kv8"]


@pytest.mark.parametrize("width,gs,kvq", GPT_QUANT, ids=GPT_QIDS)
def test_gpt_quantized_plain_versions_compose_to_the_op(width, gs, kvq):
    """CPU: the quantized GPT chain of per-kernel plain versions (the
    weight-only GEMMs with the bias, GELU and residual epilogues, the qkv
    product split per head, the unrotated write into int8 pools, the
    attention over them) is the op's plain version."""
    c, spec = _quantized(_gpt_case(torch.float32, "cpu"), width, gs, kvq,
                         _gpt_spec())
    lp, eps = c["lp"], spec.eps

    def mm(name, y, **kw):
        if width is None:
            return K.gemm_xw_ref(y, lp[name], **kw)
        return K.wo_layer_ref(y, lp[name + "__q"], lp[name + "__s"],
                              width=width, group_size=gs, **kw)
    pk, pv = _pool_copy(c["pool_k"]), _pool_copy(c["pool_v"])
    y = K.layer_norm_rows_ref(c["x"], lp["ln1_w"], lp["ln1_b"], eps)
    q, k, v = K.qkv_split_ref(mm("qkv_w", y, bias=lp["qkv_b"]), D)
    q, k = K.rope_kv_write_ref(q, k, v, None, None, pk, pv, head_dim=D,
                               block_table=c["bt"], lengths=c["lengths"])
    attn = K.paged_attention_ref(q, pk, pv, block_table=c["bt"],
                                 lengths=c["lengths"])
    xm = mm("proj_w", attn, bias=lp["proj_b"], residual=c["x"])
    y2 = K.layer_norm_rows_ref(xm, lp["ln2_w"], lp["ln2_b"], eps)
    h = mm("fc1_w", y2, bias=lp["fc1_b"], gelu=True)
    got = mm("fc2_w", h, bias=lp["fc2_b"], residual=xm)
    rk, rv = _pool_copy(c["pool_k"]), _pool_copy(c["pool_v"])
    ref = tdb.decode_block_ref(c["x"], lp, rk, rv, c["bt"], c["lengths"],
                               None, None, spec=spec)
    torch.testing.assert_close(got, ref[0], rtol=1e-5, atol=1e-5)
    for g, r in ((pk, rk), (pv, rv)):
        for a, b in zip(*(p if kvq else (p,) for p in (g, r))):
            assert torch.equal(a, b)


def test_ctypes_structs_mirror_common_cuh():
    """CPU: each ctypes Structure of ``kernels/build.py`` names the fields
    of its ``struct`` in ``csrc/common.cuh`` in their order."""
    import re
    from paddle_tpu_torch.kernels import build
    src = (Path(build.__file__).resolve().parent / "csrc" /
           "common.cuh").read_text()
    for name in ("LayerArgs", "WoArgs", "FlashArgs", "LceArgs", "NormArgs",
                 "SoftmaxArgs"):
        body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        fields = [f for decl in body.split(";") for f in re.findall(
            r"(\w+)\s*(?:\[\d+\])?\s*(?:,|$)", decl.strip())]
        assert fields == [f for f, _ in getattr(build, name)._fields_], name


def test_gpt_layer_args_checks_its_layout():
    """CPU: the GPT layer's weights are checked by their layout's names and
    shapes, and a mix of the two layers' variants is refused; a quantized
    GPT layer over int8 pools and the unrotated write into them pass the
    layout checks and go on to the device check."""
    from paddle_tpu_torch.models import gpt, llama
    assert set(layer.WEIGHTS["gpt"]) == set(gpt.block_shapes(
        gpt.GPTConfig()))
    assert set(layer.WEIGHTS["llama"]) == set(llama.block_shapes(
        llama.llama_tiny()))
    assert layer.layout(_gpt_spec()) == "gpt"
    assert layer.layout(_spec()) == "llama"
    mixed = tdb.DecodeBlockSpec(hidden=H, num_heads=HQ, kv_heads=HKV,
                                head_dim=D, block_size=BS, norm="ln")
    with pytest.raises(ValueError, match="mix"):
        layer.layout(mixed)
    from paddle_tpu_torch.ops import paged_kv as tkv
    c, spec = _quantized(_gpt_case(torch.float32, "cpu"), "int8", -1, True,
                         _gpt_spec())
    pk, pv = c["pool_k"], c["pool_v"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        layer.layer_args(pk, pv, c["bt"], M=4, lengths=c["lengths"],
                         spec=spec, x=c["x"], lp=c["lp"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        layer.layer_args(pk, pv, c["bt"], M=4, lengths=c["lengths"],
                         q=c["x"], k=c["x"], v=c["x"])
    # the attention alone over an int8 pool takes no cos / sin: it goes on
    # to the device check
    with pytest.raises(ValueError, match="CUDA tensors"):
        layer.layer_args(pk, pv, c["bt"], M=4, lengths=c["lengths"],
                         q=c["x"], attn=c["x"])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("M,Hn", [(1, 768), (4, 768), (256, 768), (4, 1001),
                                  (3, 64)],
                         ids=["M1", "M4", "M256", "H1001", "H64"])
def test_layer_norm_rows_kernel_matches_plain(dt, M, Hn):
    """The GPT chain's LayerNorm alone: the vector path at GPT-125M's H 768
    (decode, one prefill chunk) and H 64; the scalar path at H 1001; one
    launch a call, a second call bit-identical."""
    _need_card()
    rng = np.random.default_rng(23)

    def t(*shape, loc=0.0, scale=1.0):
        return torch.from_numpy((loc + scale * rng.standard_normal(shape))
                                .astype(np.float32)).to("cuda", dt)
    x, w, b = t(M, Hn, loc=0.3, scale=2.0), t(Hn, loc=1.0, scale=0.1), \
        t(Hn, scale=0.1)
    got = _once_bitwise(lambda: K.layer_norm_rows_cuda(x, w, b, 1e-5),
                        "layer_norm_rows")
    _close(got, K.layer_norm_rows_ref(x, w, b, 1e-5), dt)


# (K, N, epilogue, qkv head dim): K past a 64-row step (N 576 = 3 heads of
# 3 x 64, so 128-column tiles straddle heads and parts; N 264 past a
# 128-column tile); GPT-125M's four (qkv, proj, fc1, fc2); its qkv split at
# D 32 (every 64-column tile straddles parts) and D 128 (tiles inside one)
BIAS_GEMMS = [(520, 576, "bias_qkv", 64), (520, 264, "bias_resid", 0),
              (520, 264, "bias_gelu", 0), (768, 2304, "bias_qkv", 64),
              (768, 768, "bias_resid", 0), (768, 3072, "bias_gelu", 0),
              (3072, 768, "bias_resid", 0), (768, 2304, "bias_qkv", 32),
              (768, 2304, "bias_qkv", 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("M", [1, 4, 16, 17, 64, 255, 256, 257, 300, 512])
@pytest.mark.parametrize("Kd,N,epi,D", BIAS_GEMMS,
                         ids=[f"{e}-K{k}-N{n}" + (f"-D{d}" if d else "")
                              for k, n, e, d in BIAS_GEMMS])
def test_gemm_xw_bias_epilogues_match_plain(dt, M, Kd, N, epi, D):
    """The GPT layer's epilogues at both bf16 regimes' edges and at
    GPT-125M's widths, where the tiled plans take 128- or 64-column tiles
    and split K or not (M 17 .. 512: one, two and more 128-row tiles, and
    the edges past them): the bias (the qkv product stored split per
    head), the bias and residual, the bias and GELU; one launch a call,
    a second call bit-identical."""
    _need_card()
    rng = np.random.default_rng(M + 7)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.1).to("cuda", dt)
    x, w, b, r = t(M, Kd), t(Kd, N), t(N), t(M, N)
    kw = dict(bias=b, gelu=epi == "bias_gelu",
              residual=r if epi == "bias_resid" else None)
    split = {"qkv_head_dim": D} if D else {}
    kernel = "gemm_xw_f32" if dt == torch.float32 else \
        "gemm_xw_small_m" if M <= 16 else "gemm_xw_tiled"

    def run():
        out = K.gemm_xw_cuda(x, w, **split, **kw)
        return torch.stack(out) if split else out
    got = _once_bitwise(run, kernel)
    ref = K.gemm_xw_ref(x, w, **kw)
    if split:
        ref = torch.stack(K.qkv_split_ref(ref, D))
    _close(got, ref, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_rope_kv_write_unrotated_equals_plain_bit_for_bit(dt, mode, Dh):
    """Without cos / sin: q and k untouched, the k / v rows written into
    the pools bit for bit as the plain version writes them (dropped writes
    leave the pool alone); one rope_kv_write launch a call."""
    _need_card()
    q, k, v, _, _, pk, pv, kw = _rope_kv_inputs(dt, Dh, 1, mode)

    def run():
        qq, kk, gk, gv = q.clone(), k.clone(), pk.clone(), pv.clone()
        K.rope_kv_write_cuda(qq, kk, v, None, None, gk, gv, **kw)
        assert torch.equal(qq, q) and torch.equal(kk, k)
        return torch.cat([t.flatten() for t in (gk, gv)])
    got = _once_bitwise(run, "rope_kv_write")
    ref = _rope_kv_ref(q, k, v, None, None, pk, pv, kw)
    n = q.numel() + k.numel()
    assert torch.equal(_bits(got), _bits(ref[n:]))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_gpt_decode_block_kernel_matches_plain(dt):
    _need_card()
    c, spec = _gpt_case(dt, "cuda"), _gpt_spec()
    ref = tdb.decode_block_ref(c["x"], c["lp"], c["pool_k"].clone(),
                               c["pool_v"].clone(), c["bt"], c["lengths"],
                               None, None, spec=spec)
    pk, pv = c["pool_k"].clone(), c["pool_v"].clone()
    layer.reset_counts()
    got = tdb.decode_block(c["x"], c["lp"], pk, pv, c["bt"], c["lengths"],
                           None, None, spec=spec)
    torch.cuda.synchronize()
    gemm = "gemm_xw_f32" if dt == torch.float32 else "gemm_xw_small_m"
    assert {k: n for k, n in layer.launch_counts().items() if n} == {
        "decode_block": 1, "layer_norm_rows": 2, gemm: 4,
        "rope_kv_write": 1, "paged_attention": 1}
    _close(got[0][:3], ref[0][:3], dt)           # row 3: inactive slot
    _close(got[1], ref[1], dt)
    _close(got[2], ref[2], dt)
    changed = (pk != c["pool_k"]).flatten(2).any(-1).nonzero().tolist()
    assert sorted(map(tuple, changed)) == [(4, 1), (5, 1), (9, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("Ts,start,valid", [(16, 0, 16), (24, 5, 20),
                                            (64, 3, 64)])
def test_gpt_prefill_block_kernel_matches_plain(dt, Ts, start, valid):
    _need_card()
    c, spec = _gpt_case(dt, "cuda", seed=32), _gpt_spec()
    rng = np.random.default_rng(3)
    mb = 24
    bt_row = torch.arange(mb, dtype=torch.int32, device="cuda")
    pools = [torch.from_numpy(rng.standard_normal(
        (mb, BS, GPT_HEADS, D)).astype(np.float32)).to("cuda", dt)
        for _ in range(2)]
    pos = start + torch.arange(Ts, device="cuda")
    blk = bt_row[pos // BS]
    blk[valid:] = mb
    blk, off = blk.to(torch.int32), (pos % BS).to(torch.int32)
    x = torch.from_numpy(rng.standard_normal((1, Ts, H)).astype(
        np.float32)).to("cuda", dt)
    ref = tdb.prefill_block_ref(x, c["lp"], pools[0].clone(),
                                pools[1].clone(), blk, off, bt_row, None,
                                None, spec=spec, start=start)
    pk = pools[0].clone()
    layer.reset_counts()
    got = tdb.prefill_block(x, c["lp"], pk, pools[1].clone(), blk, off,
                            bt_row, None, None, spec=spec, start=start)
    torch.cuda.synchronize()
    gemm = "gemm_xw_f32" if dt == torch.float32 else \
        "gemm_xw_small_m" if Ts <= 16 else "gemm_xw_tiled"
    assert {k: n for k, n in layer.launch_counts().items() if n} == {
        "prefill_block": 1, "layer_norm_rows": 2, gemm: 4,
        "rope_kv_write": 1, "paged_attention": 1}
    _close(got[0][:, :valid], ref[0][:, :valid], dt)
    _close(got[1], ref[1], dt)
    _close(got[2], ref[2], dt)


WO_BIAS_W = [("int8", -1), ("int4", -1), ("int4", 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("M", [1, 4, 16, 17, 256, 300])
@pytest.mark.parametrize("epi", ["bias_qkv", "bias_resid", "bias_gelu"])
@pytest.mark.parametrize("width,gs", WO_BIAS_W,
                         ids=["int8", "int4", "int4g64"])
def test_wo_layer_bias_epilogues_match_plain(dt, M, epi, width, gs):
    """The quantized GPT layer's epilogues on the weight-only kernels at
    both bf16 regimes' edges and on the fp32 lane, K 640 (ten 64-row
    steps, five a nibble plane): the bias (the qkv product stored split
    per head, N 576 = 3 heads of 3 x 64, so 128-channel tiles straddle
    heads and parts), the bias and residual, the bias and GELU; one launch
    a call, a second call bit-identical."""
    _need_card()
    from paddle_tpu_torch.quantization import ServeQuantConfig
    from paddle_tpu_torch.quantization.serve import _quantize_matrix
    rng = np.random.default_rng(M + 11)

    def t(*shape, scale=0.1):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * scale).to("cuda")
    Kd, N = 640, 576 if epi == "bias_qkv" else 272
    codes, scale = _quantize_matrix(t(Kd, N), ServeQuantConfig(width, gs))
    x, b, r = t(M, Kd, scale=1.0).to(dt), t(N).to(dt), t(M, N).to(dt)
    kw = dict(width=width, group_size=gs, bias=b, gelu=epi == "bias_gelu",
              residual=r if epi == "bias_resid" else None)
    split = {"qkv_head_dim": 64} if epi == "bias_qkv" else {}
    kernel = "wo_layer_f32" if dt == torch.float32 else \
        f"wo_layer_{width}_{'small_m' if M <= 16 else 'tiled'}"

    def run():
        out = K.wo_layer_cuda(x, codes, scale, **split, **kw)
        return torch.stack(out) if split else out
    got = _once_bitwise(run, kernel)
    ref = K.wo_layer_ref(x, codes, scale, **kw)
    if split:
        ref = torch.stack(K.qkv_split_ref(ref, 64))
    _close(got, ref, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 8, 9, 16])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("width,gs", [("int8", -1), ("int4", 64)],
                         ids=["int8", "int4g64"])
def test_wo_dec_qkv_split_matches_plain(M, D, width, gs):
    """The quantized GPT-125M qkv product (K 768, N 2304, bias) at the
    decode rows, stored split at D 32 (8-channel chunks inside a part, 64
    channels straddling them) and D 64: within tolerance of the plain
    version, one ``wo_dec`` launch a call, a second call bit-identical."""
    _need_card()
    from paddle_tpu_torch.quantization import ServeQuantConfig
    from paddle_tpu_torch.quantization.serve import _quantize_matrix
    rng = np.random.default_rng(M + 13 * D)

    def t(*shape, scale=0.1):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * scale).to("cuda")
    Kd, N = 768, 2304
    codes, scale = _quantize_matrix(t(Kd, N), ServeQuantConfig(width, gs))
    x, b = t(M, Kd, scale=1.0).to(torch.bfloat16), t(N).to(torch.bfloat16)
    kw = dict(width=width, group_size=gs, bias=b)
    got = _once_bitwise(lambda: torch.stack(K.wo_layer_cuda(
        x, codes, scale, qkv_head_dim=D, **kw)), f"wo_layer_{width}_small_m")
    ref = torch.stack(K.qkv_split_ref(K.wo_layer_ref(x, codes, scale, **kw),
                                      D))
    _close(got, ref, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_rope_kv_write_q8_unrotated_equals_plain_bit_for_bit(dt, mode, Dh):
    """Without cos / sin into int8 pools (the quantized GPT layer): q and
    k untouched, the written rows' codes and scales equal ``quantize_kv``
    of the unrotated rows bit for bit, dropped writes leave the pools
    alone; one ``rope_kv_write_q8`` launch a call, a second call
    bit-identical."""
    _need_card()
    from paddle_tpu_torch.ops import paged_kv as tkv
    q, k, v, _, _, pk, pv, kw = _rope_kv_inputs(dt, Dh, 1, mode)
    pk, pv = (tkv.QuantizedKVPool(*tkv.quantize_kv(p)) for p in (pk, pv))

    def flat(gk, gv):
        return torch.cat([t.flatten().int() for t in (
            gk.data, _bits(gk.scale), gv.data, _bits(gv.scale))])

    def run():
        qq, kk, gk, gv = q.clone(), k.clone(), _pool_copy(pk), _pool_copy(pv)
        K.rope_kv_write_cuda(qq, kk, v, None, None, gk, gv, **kw)
        assert torch.equal(qq, q) and torch.equal(kk, k)
        return flat(gk, gv)
    got = _once_bitwise(run, "rope_kv_write_q8")
    rk, rv = _pool_copy(pk), _pool_copy(pv)
    K.rope_kv_write_ref(q, k, v, None, None, rk, rv, head_dim=Dh, **kw)
    assert torch.equal(got, flat(rk, rv))


# int8-pool attention: (G, head_dim), GPT-125M's one q head a kv head at
# D 64 first
PATTN_Q8_GD = [(1, 64), (1, 32), (1, 128), (4, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("mode", ["decode", "prefill16", "prefill256"])
@pytest.mark.parametrize("G,Dh", PATTN_Q8_GD,
                         ids=[f"G{g}-D{d}" for g, d in PATTN_Q8_GD])
def test_paged_attention_q8_matches_plain(dt, mode, G, Dh):
    """Over int8 pools: decode rows at lengths 1000 / 37 / 0 / 517 (the
    smoke's), a prefill chunk of 16 rows after 5 positions (the one-warp
    tensor-core body) and one of 256 after 300; one launch of
    ``paged_attention_q8``, a second call bit-identical."""
    _need_card()
    from paddle_tpu_torch.ops import paged_kv as tkv
    lengths = [1000, 37, 0, 517]
    rows = {"decode": 4, "prefill16": 16, "prefill256": 256}[mode]
    q, pk, pv, perm = _pattn_inputs(dt, G, Dh, 33, rows)
    pk, pv = (tkv.QuantizedKVPool(*tkv.quantize_kv(p)) for p in (pk, pv))
    if mode == "decode":
        bt = torch.full((4, 128), -1, dtype=torch.int32)
        used = 0
        for b, n in enumerate(lengths):
            need = -(-(n + 1) // 16)
            bt[b, :need] = torch.from_numpy(perm[used:used + need].astype(
                np.int32))
            used += need
        kw = dict(block_table=bt.cuda(), lengths=torch.tensor(
            lengths, dtype=torch.int32, device="cuda"))
    else:
        start = 5 if mode == "prefill16" else 300
        bt = torch.full((64,), -1, dtype=torch.int32)
        need = -(-(start + rows) // 16)
        bt[:need] = torch.from_numpy(perm[:need].astype(np.int32))
        kw = dict(block_table=bt.cuda(), start=start)
    got = _once_bitwise(lambda: K.paged_attention_cuda(q, pk, pv, **kw),
                        "paged_attention_q8")
    _close(got, K.paged_attention_ref(q, pk, pv, **kw), dt)


def _gpt_launches(entry, dt, width, kvq, rows):
    """One quantized GPT layer call's launches."""
    if width is None:
        gemm = "gemm_xw_f32" if dt == torch.float32 else \
            "gemm_xw_small_m" if rows <= 16 else "gemm_xw_tiled"
    else:
        gemm = "wo_layer_f32" if dt == torch.float32 else \
            f"wo_layer_{width}_{'small_m' if rows <= 16 else 'tiled'}"
    q8 = "_q8" if kvq else ""
    return {entry: 1, "layer_norm_rows": 2, gemm: 4,
            "rope_kv_write" + q8: 1, "paged_attention" + q8: 1}


def _close_pools(got, ref, dt, kvq):
    """Pools of a kernel call against the plain version's: int8 codes at
    most one step apart (a k a rounding apart may take the next code),
    scales to 2e-2; full-width pools at the tolerance."""
    for g, r in zip(got, ref):
        if kvq:
            assert (g.data.int() - r.data.int()).abs().max() <= 1
            _close(g.scale, r.scale, torch.bfloat16)
        else:
            _close(g, r, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("width,gs,kvq", GPT_QUANT, ids=GPT_QIDS)
def test_gpt_quantized_decode_block_kernel_matches_plain(dt, width, gs, kvq):
    _need_card()
    c, spec = _quantized(_gpt_case(dt, "cuda"), width, gs, kvq, _gpt_spec())
    rk, rv = _pool_copy(c["pool_k"]), _pool_copy(c["pool_v"])
    ref = tdb.decode_block_ref(c["x"], c["lp"], rk, rv, c["bt"],
                               c["lengths"], None, None, spec=spec)
    gk, gv = _pool_copy(c["pool_k"]), _pool_copy(c["pool_v"])
    layer.reset_counts()
    got = tdb.decode_block(c["x"], c["lp"], gk, gv, c["bt"], c["lengths"],
                           None, None, spec=spec)
    torch.cuda.synchronize()
    assert {k: n for k, n in layer.launch_counts().items() if n} == \
        _gpt_launches("decode_block", dt, width, kvq, 4)
    _close(got[0][:3], ref[0][:3], dt)           # row 3: inactive slot
    _close_pools((gk, gv), (rk, rv), dt, kvq)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
@pytest.mark.parametrize("width,gs,kvq", GPT_QUANT, ids=GPT_QIDS)
@pytest.mark.parametrize("Ts,start,valid", [(16, 0, 16), (24, 5, 20),
                                            (64, 3, 64)])
def test_gpt_quantized_prefill_block_kernel_matches_plain(dt, width, gs, kvq,
                                                          Ts, start, valid):
    _need_card()
    from paddle_tpu_torch.ops import paged_kv as tkv
    c, spec = _quantized(_gpt_case(dt, "cuda", seed=32), width, gs, kvq,
                         _gpt_spec())
    rng = np.random.default_rng(4)
    mb = 24
    bt_row = torch.arange(mb, dtype=torch.int32, device="cuda")
    pools = [torch.from_numpy(rng.standard_normal(
        (mb, BS, GPT_HEADS, D)).astype(np.float32)).to("cuda", dt)
        for _ in range(2)]
    if kvq:
        pools = [tkv.QuantizedKVPool(*tkv.quantize_kv(p)) for p in pools]
    pos = start + torch.arange(Ts, device="cuda")
    blk = bt_row[pos // BS]
    blk[valid:] = mb
    blk, off = blk.to(torch.int32), (pos % BS).to(torch.int32)
    x = torch.from_numpy(rng.standard_normal((1, Ts, H)).astype(
        np.float32)).to("cuda", dt)
    ref = tdb.prefill_block_ref(x, c["lp"], *map(_pool_copy, pools), blk,
                                off, bt_row, None, None, spec=spec,
                                start=start)
    gk, gv = map(_pool_copy, pools)
    layer.reset_counts()
    got = tdb.prefill_block(x, c["lp"], gk, gv, blk, off, bt_row, None,
                            None, spec=spec, start=start)
    torch.cuda.synchronize()
    assert {k: n for k, n in layer.launch_counts().items() if n} == \
        _gpt_launches("prefill_block", dt, width, kvq, Ts)
    _close(got[0][:, :valid], ref[0][:, :valid], dt)
    _close_pools((gk, gv), ref[1:], dt, kvq)


# ------------------------------------------------------ BERT fine-tune
@pytest.mark.gpu
def test_bert_no_dropout_step_launches_the_flash_kernels_once_a_layer():
    """A 2-layer BERT (H 128, 2 heads of 64) fp32 fine-tune step with both
    dropouts 0 and no pad mask: attention takes flash, so the step launches
    ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` exactly once a
    layer and nothing else of the library; its loss is within 1e-4
    (relative) and every gradient within relative L2 1e-4 of the same step
    on the CPU, each key bias held with its weight as one leaf
    (``chip_smoke.bert_leaves``: its gradient is zero but for rounding)."""
    _need_card()
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_tiny(hidden_size=128, num_heads=2, num_layers=2,
                         hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)
    rng = np.random.default_rng(24)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)))
    labels = torch.from_numpy(rng.integers(0, 2, (4,)))
    net = bert.BertForSequenceClassification(cfg, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        net = net.to(dev)
        layer.reset_counts()
        loss = net(ids.to(dev), labels=labels.to(dev))
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert {k: n for k, n in layer.launch_counts().items() if n} == {
                "flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
        runs[dev] = (float(loss), {k: p.grad.detach().cpu().clone()
                                   for k, p in net.named_parameters()})
        net.zero_grad(set_to_none=True)
    (lc, gc), (lp, gp) = runs["cuda"], runs["cpu"]
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    gc, gp = cs.bert_leaves(gc), cs.bert_leaves(gp)
    assert len(gp) == len(runs["cpu"][1]) - 2
    for k, g in gp.items():
        assert float((gc[k] - g).norm()) <= 1e-4 * float(g.norm()), k


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{"fused_decode_block": False},
                                {"fused_prefill": False}],
                         ids=lambda kw: next(iter(kw)))
def test_engine_unfused_chain_is_refused_on_cuda(kw):
    """The port has no per-op CUDA chain: an engine asked for one on the
    card raises, naming the bench's serve rows (ROADMAP queue 1 item 13);
    True for both builds."""
    _need_card()
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models import llama
    cfg = llama.llama_tiny()
    params = llama.init_params(cfg, make_generator(0, "cuda"), device="cuda")
    with pytest.raises(NotImplementedError, match="item 13"):
        ContinuousBatchingEngine(cfg, params, **kw)
    eng = ContinuousBatchingEngine(cfg, params, fused_decode_block=True,
                                   fused_prefill=True)
    assert eng.fused_decode_block and eng.fused_prefill


# --------------------------------------------------------------------------
# the engine's programs as CUDA graphs (aot/graphs.py)
# --------------------------------------------------------------------------
GRAPH_LENS, GRAPH_NEW = (5, 40, 17, 23, 9), 6


def _graph_engine(quant=False, spec=False, **kw):
    """A bf16 Llama at kernel-legal widths (head_dim 32), B 4, bucketed
    prefill, the features that reorder admissions off."""
    from paddle_tpu_torch.device import make_generator
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.quantization import ServeQuantConfig
    from paddle_tpu_torch.spec_decode import SpecDecodeConfig
    cfg = llama.llama_tiny(hidden_size=128, intermediate_size=256,
                           dtype="bfloat16")
    params = llama.init_params(cfg, make_generator(0, "cuda"), device="cuda")
    if spec:
        kw["spec_config"] = SpecDecodeConfig(draft_cfg=cfg,
                                             draft_params=params, k=3,
                                             window=8)
    if quant:
        kw["quant_config"] = ServeQuantConfig(weight_dtype="int8",
                                              kv_dtype="int8")
    return ContinuousBatchingEngine(
        cfg, params, max_batch=4, block_size=16, num_blocks=32,
        prefill_buckets=(16,), enable_prefix_caching=False,
        enable_preemption=False, **kw)


def _graph_serve(eng):
    """Ids and launch counts of one run: every request queued before the
    first step, the second and fourth sampled."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32)
               for n in GRAPH_LENS]
    layer.reset_counts()
    rids = [eng.add_request(p, GRAPH_NEW, **(
        dict(temperature=0.9, top_k=20, top_p=0.9, seed=i)
        if i in (1, 3) else {})) for i, p in enumerate(prompts)]
    out = eng.run_to_completion()
    counts = {k: n for k, n in layer.launch_counts().items() if n}
    return [out[r] for r in rids], counts


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("spec", [False, True], ids=["base", "spec"])
def test_engine_graphs_serve_the_eager_chains_ids(quant, spec):
    """Replays of the captured decode step, sampler, draft and verify give
    the eager launch chain's ids bit for bit (greedy and sampled), and the
    launch counts through replays are the eager run's plus the captures'
    warm-up calls."""
    _need_card()
    eng = _graph_engine(quant, spec)
    got, counts = _graph_serve(eng)
    ref_eng = _graph_engine(quant, spec)
    ref_eng._set_eager(True)
    want, ref_counts = _graph_serve(ref_eng)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    graphs = eng.aot_stats()["graphs"]
    names = {"spec_draft", "spec_verify", "sampler"} if spec else \
        {"decode", "sampler"}
    assert set(graphs) == names and all(graphs[n]["replays"]
                                        for n in names)
    warm = {}
    for g in graphs.values():
        for k, n in g["warmup_launches"].items():
            warm[k] = warm.get(k, 0) + n
    assert counts == {k: ref_counts.get(k, 0) + warm.get(k, 0)
                      for k in set(ref_counts) | set(warm)}
    assert "graphs" not in ref_eng.aot_stats() or \
        not ref_eng.aot_stats()["graphs"]


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_engine_graph_capture_leaves_the_pools(quant):
    """Warm-up and capture run on a block table of -1: pools full of
    random bytes are unchanged, byte for byte."""
    _need_card()
    from paddle_tpu_torch.ops.paged_kv import is_quantized_pool
    eng = _graph_engine(quant, spec=True)
    parts = [p for pool in (eng.pool_k, eng.pool_v)
             for p in ((pool.data, pool.scale) if is_quantized_pool(pool)
                       else (pool,))]
    gen = torch.Generator(device="cuda").manual_seed(3)
    for p in parts:
        p.view(torch.uint8).copy_(torch.randint(
            0, 256, p.view(torch.uint8).shape, generator=gen,
            device="cuda", dtype=torch.uint8))
    before = [p.clone() for p in parts]
    eng._capture_all()
    torch.cuda.synchronize()
    assert set(eng._graphs) == {"decode", "sampler", "spec_draft",
                                "spec_verify"}
    for p, b in zip(parts, before):
        assert torch.equal(p.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.gpu
def test_failed_capture_raises_naming_the_program():
    """A program that syncs with the host cannot be captured: the capture
    raises ``GraphCaptureError`` naming it (no eager fallback), and a
    later capture works."""
    _need_card()
    from paddle_tpu_torch.aot.graphs import CapturedProgram, GraphCaptureError
    x = torch.arange(8.0, device="cuda")
    with pytest.raises(GraphCaptureError, match="host_sync"):
        CapturedProgram("host_sync", lambda x: x * float(x.sum().item()),
                        {"x": x})
    prog = CapturedProgram("double", lambda x: x * 2, {"x": x})
    out = prog(x=np.full(8, 3.0, np.float32))
    assert out.tolist() == [6.0] * 8 and prog.stats()["replays"] == 1
