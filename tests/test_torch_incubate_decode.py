"""The port's incubate serving calls (``paddle_tpu_torch.incubate.nn``)
against the JAX package's (``paddle_tpu.incubate.nn``).

The same numpy-seeded inputs go to both packages (the port gets copies).
The JAX side runs on its reference tier and, where a Pallas kernel is on
its path (``decode_attention`` for MMHA and the decode phase, flash for
the context phase), under ``set_flags({"pallas_interpret": True})`` too.
Tolerances: fp32 1e-5, bf16 2e-2 (relative and absolute).

* ``masked_multihead_attention`` at B 3, H 2, D 64, T_max 32 (the kernel-3
  path at a head_dim the card's kernel takes), lengths 5 / 0 / 31 (a
  zero-length row and the last slot): bias, the int32 QKV dequant (fp32 q
  over a bf16 cache), interleaved RoPE from a pre-gathered row, neox RoPE
  over two sections from a full table read at each row's length
  (clipped), ``src_mask`` and beam offsets (the dense path),
  ``out_shift`` / ``out_smooth``, the int8 store in both rounding modes;
  every argument error of the JAX function.
* The documented divergence: the port writes the caller's cache in place
  and returns it (JAX returns a new array and leaves its input as it was);
  the values are JAX's.
* ``fused_multi_transformer`` at 2 layers, E 64, H 4 (D 16): the context
  phase with and without caches, ``pre_caches`` (context and decode),
  ``rotary_embs``, post-LN and ``trans_qkvw=False``; prefill then decode
  equal to the context forward on S + 1 (as
  ``tests/test_fused_multi_transformer.py`` holds the JAX op); the
  tanh-GELU and clamped-RoPE-start quirks of the JAX chain.
* ``FusedMultiTransformer`` carried across by ``state_dict_from_numpy``,
  ``FusedTransformer`` in eval, ``block_multihead_attention`` and
  ``blha_get_max_len``.
* ``decode_attention_ref`` on the head-major view of a cache equal to the
  same call on a contiguous copy.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core.flags import FLAGS, set_flags
from paddle_tpu.incubate import nn as jinc
from paddle_tpu.incubate.nn import functional as jIF
from paddle_tpu_torch.bridge import state_dict_from_numpy
from paddle_tpu_torch.incubate import nn as tinc
from paddle_tpu_torch.incubate.nn import functional as tIF
from paddle_tpu_torch.ops import decode_attention as tda

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TIERS = ["reference", "interpret"]


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().float()
    v = v.numpy() if hasattr(v, "numpy") else v
    return np.array(np.asarray(v), dtype=np.float32, copy=True)


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, dt):
    np.testing.assert_allclose(_np(got.detach().float()), _np(want),
                               **TOL[dt])


def _jx(a, dt="float32"):
    t = pt.to_tensor(np.array(a, copy=True))
    return t.astype(dt) if dt != "float32" else t


def _tx(a, dt="float32"):
    return torch.from_numpy(np.array(a, copy=True)).to(TDT[dt])


@pytest.fixture
def tier(request):
    """Runs the JAX side on one tier; restores the flag after."""
    old = FLAGS.pallas_interpret
    set_flags({"pallas_interpret": request.param == "interpret"})
    yield request.param
    set_flags({"pallas_interpret": old})


# ------------------------------------------------------------------- MMHA
MB, MH, MD, MT = 3, 2, 64, 32
LENS = np.array([5, 0, 31], np.int32)


def _mmha_inputs(case, dt):
    """(port kwargs, JAX kwargs, cache dtype) of one MMHA case."""
    x = _x(1, MB, 3 * MH * MD)
    cache = _x(2, 2, MB, MH, MT, MD)
    kw_np, x_dt = {}, dt
    if case == "bias":
        kw_np["bias"] = _x(3, 3 * MH * MD, scale=0.5)
    if case == "qkv_out_scale":
        x = np.round(x * 1000).astype(np.int32)
        kw_np["qkv_out_scale"] = np.abs(_x(4, 3, MH, MD)) * 1e-3
        x_dt = None
    if case == "rope interleaved row":
        ang = _x(5, MB, 1, 1, MD)
        kw_np["rotary_tensor"] = np.stack([np.cos(ang), np.sin(ang)])
    if case == "rope neox table clipped":
        ang = _x(6, MB, 20, 1, MD)       # 20 rows: length 31 reads row 19
        kw_np["rotary_tensor"] = np.stack([np.cos(ang), np.sin(ang)])
        kw_np["rotary_emb_dims"] = 2
        kw_np["use_neox_rotary_style"] = True
    if case == "src_mask":
        m = np.where(_x(7, MB, 1, 1, 24) > 1.0, -1e4, 0.0)
        kw_np["src_mask"] = m.astype(np.float32)      # shorter than T
    if case == "beam":
        kw_np["beam_cache_offset"] = np.random.default_rng(8).integers(
            0, 3, (1, 3, MT)).astype(np.int32)
    if case == "shift smooth":
        kw_np["out_shift"] = _x(9, MH * MD)
        kw_np["out_smooth"] = _x(10, MH * MD)
    scalars = {}
    if case.startswith("int8 round"):
        scalars = dict(out_scale=0.05, quant_round_type=int(case[-1]))

    def port():
        kw = {k: (_tx(v) if v.dtype != np.int32 else torch.from_numpy(
            v.copy())) for k, v in kw_np.items() if isinstance(v, np.ndarray)}
        kw.update({k: v for k, v in kw_np.items()
                   if not isinstance(v, np.ndarray)})
        if "bias" in kw:
            kw["bias"] = kw["bias"].to(TDT[dt])
        xt = torch.from_numpy(x.copy()) if x_dt is None else _tx(x, dt)
        return dict(x=xt, cache_kv=_tx(cache, dt),
                    sequence_lengths=torch.from_numpy(LENS.copy()),
                    **kw, **scalars)

    def jax():
        kw = {k: (_jx(v) if isinstance(v, np.ndarray) and v.dtype != np.int32
                  else pt.to_tensor(v) if isinstance(v, np.ndarray) else v)
              for k, v in kw_np.items()}
        if "bias" in kw:
            kw["bias"] = _jx(kw_np["bias"], dt)
        xj = pt.to_tensor(x) if x_dt is None else _jx(x, dt)
        return dict(x=xj, cache_kv=_jx(cache, dt),
                    sequence_lengths=pt.to_tensor(LENS), **kw, **scalars)
    return port, jax


MMHA_CASES = [("plain", "float32"), ("plain", "bfloat16"),
              ("bias", "bfloat16"), ("qkv_out_scale", "float32"),
              ("qkv_out_scale", "bfloat16"),
              ("rope interleaved row", "float32"),
              ("rope neox table clipped", "float32"),
              ("src_mask", "float32"), ("beam", "float32"),
              ("shift smooth", "float32"), ("int8 round 0", "float32"),
              ("int8 round 1", "float32")]


def _check_mmha(case, dt):
    port, jax = _mmha_inputs(case, dt)
    args = port()
    cache_in = args["cache_kv"]
    before = cache_in.clone()
    got = tIF.masked_multihead_attention(**args)
    want = jIF.masked_multihead_attention(**jax())
    assert len(got) == len(want) == (3 if case == "beam" else 2)
    assert got[1] is cache_in                     # written in place
    if case.startswith("int8"):
        assert got[0].dtype == torch.int8
        # |a - b| <= 1 code: a value a rounding apart may sit on a half step
        assert np.abs(_np(got[0]) - _np(want[0])).max() <= 1
        assert (_np(got[0]) == _np(want[0])).mean() > 0.97
    else:
        assert got[0].dtype == TDT[dt]
        _close(got[0], want[0], dt)
    _close(got[1], want[1], dt)
    rows = torch.zeros(MB, MT, dtype=torch.bool)
    rows[torch.arange(MB), torch.from_numpy(LENS).long()] = True
    touched = rows[None, :, None, :, None].expand_as(cache_in)
    assert torch.equal(cache_in[~touched], before[~touched])
    if case == "beam":
        assert got[2] is args["beam_cache_offset"]


@pytest.mark.parametrize("tier", ["interpret"], indirect=True)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["plain", "qkv_out_scale"])
def test_mmha_matches_jax_interpret_kernel(case, dt, tier):
    _check_mmha(case, dt)


@pytest.mark.parametrize("tier", ["reference"], indirect=True)
@pytest.mark.parametrize("case,dt", MMHA_CASES,
                         ids=[f"{c}-{d}" for c, d in MMHA_CASES])
def test_mmha_matches_jax_reference(case, dt, tier):
    _check_mmha(case, dt)


def test_mmha_cache_divergence_in_place_values_equal():
    """Paddle's contract: the cache argument is updated in place and
    returned.  JAX returns a new array equal to the port's and leaves
    its input as it was."""
    port, jax = _mmha_inputs("plain", "float32")
    pa, ja = port(), jax()
    j_in = _np(ja["cache_kv"])
    out, cache = tIF.masked_multihead_attention(**pa)
    jout, jcache = jIF.masked_multihead_attention(**ja)
    assert cache is pa["cache_kv"]
    np.testing.assert_array_equal(_np(ja["cache_kv"]), j_in)  # JAX: new
    _close(cache, jcache, "float32")
    assert not np.array_equal(_np(cache), j_in)  # the port: in place
    _close(out, jout, "float32")


MMHA_ERRORS = [
    ("rotary_emb_dims without tensor", dict(rotary_emb_dims=1),
     "rotary_tensor is None"),
    ("rotary_emb_dims 3", dict(rotary_emb_dims=3, rotary_tensor="row"),
     "must be 0/1/2"),
    ("beam without cache", dict(cache_kv=None, beam_cache_offset="ok"),
     "requires cache_kv"),
    ("shift without smooth", dict(out_shift="vec"), "provided together"),
    ("beam shape", dict(beam_cache_offset="short batch"), "beam_size"),
    ("beam last dim", dict(beam_cache_offset="short"), "capacity"),
    ("cache full", dict(sequence_lengths="full"), "cache full"),
    ("no lengths", dict(sequence_lengths=None), "sequence_lengths"),
    ("rotary shape", dict(rotary_tensor="bad"), "rotary_tensor must pack"),
]


@pytest.mark.parametrize("label,change,match", MMHA_ERRORS,
                         ids=[e[0] for e in MMHA_ERRORS])
def test_mmha_argument_errors_match_jax(label, change, match):
    values = {"row": np.zeros((2, MB, 1, 1, MD), np.float32),
              "ok": np.zeros((1, MB, MT), np.int32),
              "vec": np.zeros(MH * MD, np.float32),
              "short batch": np.zeros((1, 2, MT), np.int32),
              "short": np.zeros((1, MB, MT - 1), np.int32),
              "full": np.array([5, MT, 1], np.int32),
              "bad": np.zeros((2, MB, 1, 1, MD - 1), np.float32)}
    port, jax = _mmha_inputs("plain", "float32")
    pa, ja = port(), jax()
    for k, v in change.items():
        if isinstance(v, str):
            v = values[v]
            pa[k] = torch.from_numpy(v.copy())
            ja[k] = pt.to_tensor(v)
        else:
            pa[k] = ja[k] = v
    with pytest.raises(ValueError, match=match):
        jIF.masked_multihead_attention(**ja)
    with pytest.raises(ValueError, match=match):
        tIF.masked_multihead_attention(**pa)


def test_decode_attention_ref_reads_a_head_major_view_as_a_copy():
    """Kernel 3's plain version on ``cache[0].transpose(1, 2)`` (strides
    H T D, D, T D) equals it on a contiguous copy (to fp32 rounding: the
    CPU products take another order on strided operands), and the op's
    CPU dispatch is that plain version."""
    cache = torch.from_numpy(_x(11, 2, MB, MH, MT, MD))
    q = torch.from_numpy(_x(12, MB, MH, MD))
    lt = torch.tensor([32, 1, 17], dtype=torch.int32)
    kv = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    assert kv[0].stride() == (MH * MT * MD, MD, MT * MD, 1)
    want = tda.decode_attention_ref(q, *(t.contiguous() for t in kv), lt)
    got = tda.decode_attention_ref(q, *kv, lt)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(tda.decode_attention(q, *kv, lt), got)


# ------------------------------------------------ fused_multi_transformer
B, S, E, H, FF, L = 2, 6, 64, 4, 128, 2
D = E // H
NAMES = ("ln_s", "ln_b", "qkvw", "qkvb", "lw", "lb", "flns", "flnb", "f1w",
         "f1b", "f2w", "f2b")


def _fmt_params(trans=True, seed=20):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.1, base=0.0):
        return [(base + rng.standard_normal(shape) * scale).astype(
            np.float32) for _ in range(L)]
    return {"ln_s": t(E, base=1.0), "ln_b": t(E),
            "qkvw": t(*((3, H, D, E) if trans else (E, 3, H, D))),
            "qkvb": t(3, H, D), "lw": t(E, E), "lb": t(E),
            "flns": t(E, base=1.0), "flnb": t(E), "f1w": t(E, FF),
            "f1b": t(FF), "f2w": t(FF, E), "f2b": t(E)}


def _fmt(side, x, p, dt, caches=None, pre=None, rot=None, **kw):
    """One call of either package on copies of the numpy inputs; returns
    ``(y, caches)`` as numpy (caches None without them) and, for the
    port, the cache tensors it was given."""
    conv = _tx if side == "port" else _jx
    fn = tIF.fused_multi_transformer if side == "port" else \
        jIF.fused_multi_transformer
    lists = [[conv(a, dt) for a in p[n]] for n in NAMES]
    given = None if caches is None else [conv(c, dt) for c in caches]
    if kw.get("attn_mask") is not None:
        kw["attn_mask"] = conv(kw["attn_mask"])
    out = fn(conv(x, dt), *lists, cache_kvs=given,
             pre_caches=None if pre is None else [conv(c, dt) for c in pre],
             rotary_embs=None if rot is None else conv(rot), **kw)
    if caches is None:
        return out, None, None
    return out[0], out[1], given


def _check_fmt(dt, x, p, caches=None, **kw):
    yp, cp, given = _fmt("port", x, p, dt, caches, **kw)
    yj, cj, _ = _fmt("jax", x, p, dt, caches, **kw)
    _close(yp, yj, dt)
    if caches is not None:
        assert all(a is b for a, b in zip(cp, given))
        for a, b in zip(cp, cj):
            _close(a, b, dt)
    return yp, cp


def _rot(seed, s_max):
    ang = _x(seed, B, 1, s_max, D)
    return np.stack([np.cos(ang), np.sin(ang)])


@pytest.mark.parametrize("tier", TIERS, indirect=True)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fmt_context_matches_jax(dt, tier):
    """No caches: causal flash attention (kernel 6's path)."""
    _check_fmt(dt, _x(21, B, S, E), _fmt_params())


FMT_CONTEXT = {
    "post-LN trans_qkvw False": dict(pre_layer_norm=False, trans_qkvw=False),
    "rotary_embs": dict(rot=10),
    "pre_caches": dict(pre=3),
    "attn_mask + pre_caches": dict(pre=3, mask=True),
}


POST_LN = "post-LN trans_qkvw False"


@pytest.mark.parametrize("tier", ["reference"], indirect=True)
@pytest.mark.parametrize("case,dt", [
    (c, dt) for c in FMT_CONTEXT for dt in ("float32", "bfloat16")
    if (c, dt) != (POST_LN, "bfloat16")])
def test_fmt_context_with_caches_then_decode_matches_jax(case, dt, tier):
    """The context phase fills the caches (prefix first), then a decode
    step at time_step S writes slot S + P (in bf16 through kernel 3's
    plain version on the head-major caches); outputs and caches equal
    JAX's at both calls."""
    kw = dict(FMT_CONTEXT[case])
    p = _fmt_params(trans=kw.get("trans_qkvw", True))
    P = kw.pop("pre", 0)
    T = S + P + 4
    caches = [_x(30 + i, 2, B, H, T, D) for i in range(L)]
    if P:
        kw["pre"] = [_x(40 + i, 2, B, H, P, D) for i in range(L)]
    if kw.pop("mask", False):
        kw["attn_mask"] = np.where(np.tril(np.ones((S, S))) > 0, 0.0,
                                   -1e4).astype(np.float32)[None, None]
    if "rot" in kw:
        kw["rot"] = _rot(22, kw["rot"])
    y, cp = _check_fmt(dt, _x(23, B, S, E), p, caches, **kw)
    caches = [_np(c) for c in cp]
    kw.pop("attn_mask", None)
    _check_fmt(dt, _x(24, B, 1, E), p, caches, time_step=S, **kw)


@pytest.mark.parametrize("tier", ["reference"], indirect=True)
def test_fmt_post_ln_bf16_decode_as_close_to_fp32_as_jax(tier):
    """Post-LN in bf16: the context call equals JAX's at 2e-2; at the
    decode step the last LayerNorm divides the residual's rounding by its
    spread, and port and JAX part by a little more than 2e-2 at single
    elements (JAX's own reference and Pallas-interpret tiers part by more
    there), so the port's step is held to be no further from the fp32
    chain over the same bf16 values than JAX's step is (1.5x), its cache
    write at 2e-2."""
    kw = dict(FMT_CONTEXT[POST_LN])
    p = _fmt_params(trans=False)
    caches = [_x(30 + i, 2, B, H, S + 4, D) for i in range(L)]
    _, cp = _check_fmt("bfloat16", _x(23, B, S, E), p, caches, **kw)
    caches = [_np(c) for c in cp]
    x = _x(24, B, 1, E)
    yp, cpp, _ = _fmt("port", x, p, "bfloat16", caches, time_step=S, **kw)
    yj, cj, _ = _fmt("jax", x, p, "bfloat16", caches, time_step=S, **kw)
    for a, b in zip(cpp, cj):
        _close(a, b, "bfloat16")

    def bf(a):
        return _np(torch.from_numpy(a).bfloat16())
    truth, _, _ = _fmt("port", bf(x), {n: [bf(a) for a in v]
                                       for n, v in p.items()},
                       "float32", caches, time_step=S, **kw)
    truth = _np(truth)
    port, jax_ = (np.abs(_np(y) - truth).max() for y in (yp, yj))
    assert port <= 1.5 * jax_, (port, jax_)


def test_fmt_prefill_then_decode_equals_context_on_s_plus_1():
    """Port only, fp32: prefill S tokens, decode token S (kernel 3's path
    on the head-major caches) == the context forward on S + 1."""
    p = _fmt_params()
    x = _x(25, B, S + 1, E)
    full, _, _ = _fmt("port", x, p, "float32")
    caches = [np.zeros((2, B, H, S + 4, D), np.float32) for _ in range(L)]
    _, cp, _ = _fmt("port", x[:, :S], p, "float32", caches)
    dec, _, _ = _fmt("port", x[:, S:], p, "float32",
                     [c.numpy() for c in cp], time_step=S)
    torch.testing.assert_close(dec[:, 0], full[:, S], rtol=1e-5, atol=1e-5)


def test_fmt_gelu_is_the_tanh_approximation():
    """``getattr(jax.nn, "gelu")`` is the tanh GELU: the port equals JAX,
    and the exact GELU would not."""
    p, x = _fmt_params(), _x(26, B, S, E, scale=3.0)
    yj = _np(jIF.fused_multi_transformer(
        _jx(x), *[[_jx(a) for a in p[n]] for n in NAMES]))
    _close(_fmt("port", x, p, "float32")[0], yj, "float32")
    saved = tIF._JAX_NN_ACTS["gelu"]
    tIF._JAX_NN_ACTS["gelu"] = torch.nn.functional.gelu
    try:
        exact = _fmt("port", x, p, "float32")[0]
    finally:
        tIF._JAX_NN_ACTS["gelu"] = saved
    assert np.abs(_np(exact) - yj).max() > 1e-4


def test_fmt_rope_start_clamps_to_the_table_end():
    """``dynamic_slice_in_dim`` clamps the RoPE start to ``S_max - S``: a
    decode step at time_step 12 over a 10-row table rotates with row 9,
    as JAX does (the cache slot stays 12)."""
    p = _fmt_params()
    rot = _rot(27, 10)
    caches = [_x(50 + i, 2, B, H, 16, D) for i in range(L)]
    x = _x(28, B, 1, E)
    y, _ = _check_fmt("float32", x, p, caches, rot=rot, time_step=12)
    moved = np.concatenate([rot, np.repeat(rot[:, :, :, 9:10], 6, 3)], 3)
    moved[:, :, :, 12] = rot[:, :, :, 9]
    y2, _, _ = _fmt("port", x, p, "float32", caches, rot=moved, time_step=12)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    y3, _, _ = _fmt("port", x, p, "float32", caches, rot=_rot(27, 16),
                    time_step=12)
    assert not torch.allclose(y, y3)


def test_fmt_refusals():
    p, x = _fmt_params(), _tx(_x(29, B, S, E))
    lists = [[_tx(a) for a in p[n]] for n in NAMES]
    with pytest.raises(NotImplementedError, match="training-mode dropout"):
        tIF.fused_multi_transformer(x, *lists, dropout_rate=0.1,
                                    training=True)
    with pytest.raises(ValueError, match="activation"):
        tIF.fused_multi_transformer(x, *lists, activation="gelu_new")
    caches = [torch.zeros(2, B, H, 4, D) for _ in range(L)]
    with pytest.raises(ValueError, match="capacity"):
        tIF.fused_multi_transformer(x[:, :1], *lists, cache_kvs=caches,
                                    time_step=4)
    with pytest.raises(NotImplementedError, match="masked_multihead"):
        tIF.fused_multi_head_attention(x, torch.zeros(3, H, D, E),
                                       torch.zeros(E, E), cache_kv=caches[0])


# ------------------------------------------------------------- the layers
@pytest.mark.parametrize("tier", ["interpret"], indirect=True)
def test_fused_multi_transformer_layer_carried_across(tier):
    """A JAX layer's ``state_dict()`` loads into the port's layer
    unchanged; the context call and a decode step agree."""
    pt.seed(3)
    jl = jinc.FusedMultiTransformer(E, H, FF, num_layers=L)
    jl.eval()
    tl = tinc.FusedMultiTransformer(E, H, FF, num_layers=L, device="cpu")
    sd = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    assert set(tl.state_dict()) == set(sd)
    tl.load_state_dict(state_dict_from_numpy(sd, device="cpu"))
    tl.eval()
    x, T = _x(31, B, S, E), S + 2
    caches = [np.zeros((2, B, H, T, D), np.float32) for _ in range(L)]
    tc = [_tx(c) for c in caches]
    yt, tc2 = tl(_tx(x), caches=tc)
    yj, jc = jl(_jx(x), caches=[_jx(c) for c in caches])
    _close(yt, yj, "float32")
    assert all(a is b for a, b in zip(tc, tc2))
    x1 = _x(32, B, 1, E)
    yt, _ = tl(_tx(x1), caches=tc, time_step=S)
    yj, _ = jl(_jx(x1), caches=jc, time_step=S)
    _close(yt, yj, "float32")


@pytest.mark.parametrize("tier", ["reference"], indirect=True)
def test_fused_transformer_matches_jax_in_eval(tier):
    pt.seed(4)
    jl = jinc.FusedTransformer(E, H, L, FF)
    jl.eval()
    tl = tinc.FusedTransformer(E, H, L, FF, device="cpu")
    sd = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    assert set(tl.state_dict()) == set(sd)
    tl.load_state_dict(state_dict_from_numpy(sd, device="cpu"))
    tl.eval()
    x = _x(33, B, S, E)
    with torch.no_grad():
        _close(tl(_tx(x)), jl(_jx(x)).numpy(), "float32")


# --------------------------------------------------- block attention
@pytest.mark.parametrize("block_size", [None, 4])
def test_block_multihead_attention_matches_jax(block_size):
    """One decode step over 4-row pages (``block_size`` None reads the
    pool's page size); an unmapped page drops its write; the pools are
    written in place."""
    NB, BS = 8, 4
    qkv = _x(34, 3, 3, H, D)
    kc, vc = _x(35, NB, BS, H, D), _x(36, NB, BS, H, D)
    bt = np.array([[2, 5, -1], [0, -1, -1], [7, 1, 3]], np.int32)
    dec = np.array([6, 4, 9], np.int32)        # row 1's page 1 is unmapped
    enc = np.array([3, 9, 1], np.int32)
    pk, pv = _tx(kc), _tx(vc)
    out, k2, v2 = tIF.block_multihead_attention(
        _tx(qkv), pk, pv, torch.from_numpy(enc), torch.from_numpy(dec),
        None, block_tables=torch.from_numpy(bt), block_size=block_size)
    jout, jk, jv = jIF.block_multihead_attention(
        _jx(qkv), _jx(kc), _jx(vc), pt.to_tensor(enc), pt.to_tensor(dec),
        None, block_tables=pt.to_tensor(bt), block_size=block_size)
    assert k2 is pk and v2 is pv
    _close(out, jout, "float32")
    _close(k2, jk, "float32")
    _close(v2, jv, "float32")
    got = tIF.blha_get_max_len(torch.from_numpy(enc), torch.from_numpy(dec))
    want = jIF.blha_get_max_len(pt.to_tensor(enc), pt.to_tensor(dec))
    assert [int(g) for g in got] == [int(np.asarray(w.numpy()))
                                     for w in want] == [9, 9]
