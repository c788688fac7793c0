"""The port's transformer family (``paddle_tpu_torch.nn.transformer``)
against the JAX package's ``paddle_tpu/nn/layer/transformer.py``.

d_model 32, 4 heads (head_dim 8), FFN 64, batch 2, source length 6,
target / memory length 5, inputs from numpy seeds, dropout 0.  Each JAX
layer is built after ``pt.seed`` and run as one jitted program over its
parameters (``functional_state``); its ``state_dict()`` goes to the port
through ``bridge.state_dict_from_numpy``.  JAX's reference tier (the dense
``_sdpa_ref`` chain on the CPU) gives, at fp32 1e-5 and bf16 2e-2
(relative and absolute):

* ``MultiHeadAttention``: self attention without a mask, with a boolean
  ``[B, 1, S, S]`` mask and with an additive ``[B, 1, 1, S]`` one; cross
  attention with ``kdim`` / ``vdim`` and an additive ``[B, H, Sq, Sk]``
  mask; the ``cache`` path (``gen_cache``, then two calls), in fp32 and in
  bf16, where the fp32 cache promotes the output and caches to fp32;
* ``TransformerEncoderLayer`` pre-LN and post-LN with relu and gelu (and
  its ``cache`` path);
* ``TransformerEncoder`` with a final norm: output, and the gradients of
  every parameter and of the input;
* ``Transformer`` (encoder and decoder stacks, pre-LN with their final
  norms, and post-LN) under ``generate_square_subsequent_mask``.

Without a mask and without dropout the JAX path reaches flash on the TPU,
so those cases are also held to JAX under ``pallas_interpret``.  Also:
deep-copied layers start equal, share the caller's generator and draw
different dropout masks; attention takes flash exactly where JAX routes
to it; JAX's eager optimizer, keyed by parameter name, updates one of two
deep-copied layers (their parameters share names) where the port's
updates both (a documented divergence); the layers default to CUDA.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.core.flags import FLAGS, set_flags
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.bridge import state_dict_from_numpy
from paddle_tpu_torch.nn import functional as TF

B, S, T, E, H, FF = 2, 6, 5, 32, 4, 64
KDIM, VDIM = 24, 20
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _np(v):
    return np.array(np.asarray(v), dtype=np.float32, copy=True)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _masks():
    rng = np.random.default_rng(7)
    keep = rng.random((B, 1, S, S)) < 0.7
    keep[..., 0] = True                     # every row keeps one key
    add = np.where(rng.random((B, 1, 1, S)) < 0.3, -1e9, 0.0).astype(
        np.float32)
    add[..., 0] = 0.0
    cross = (rng.standard_normal((B, H, S, T)) * 2).astype(np.float32)
    return dict(bool=keep, add=add, cross=cross)


def _jit(net):
    """``net`` as a jitted function of ``(params, *args)`` (None args
    stay None; tuples of arrays become tuples of Tensors)."""
    def wrap(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return tuple(pt.Tensor(v) for v in a)
        return pt.Tensor(a)

    def call(params, *args):
        with jnn.functional_state(net, params):
            out = net(*(wrap(a) for a in args))
        return jax.tree_util.tree_map(
            lambda v: v._value, out,
            is_leaf=lambda v: isinstance(v, pt.Tensor))
    return jax.jit(call)


def _in_tier(interpret, fn):
    old = FLAGS.pallas_interpret
    set_flags({"pallas_interpret": interpret})
    try:
        return fn()
    finally:
        set_flags({"pallas_interpret": old})


def _port(jlayer, tlayer):
    sd = {k: _np(v) for k, v in jlayer.state_dict().items()}
    tlayer.load_state_dict(state_dict_from_numpy(sd, device="cpu"))
    assert list(tlayer.state_dict()) == list(sd)
    return tlayer.eval()


def _t(a, dt="float32"):
    """A torch copy of ``a``; float arrays in ``dt``, booleans as they
    are."""
    t = torch.from_numpy(np.array(a, copy=True))
    return t if t.dtype == torch.bool else t.to(getattr(torch, dt))


def _close(got, want, dt="float32"):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               **TOL[dt])


# ----------------------------------------------------- MultiHeadAttention
MHA_CASES = {
    "self": (False, None), "self-bool-mask": (False, "bool"),
    "self-additive-mask": (False, "add"), "cross-kdim-vdim": (True, "cross")}


@pytest.fixture(scope="module")
def mha():
    """Per case: the JAX layer, its output in the reference tier and, for
    the unmasked case, under interpret mode."""
    masks, q = _masks(), _x(1, B, S, E)
    kv = (_x(2, B, T, KDIM), _x(3, B, T, VDIM))
    out = {}
    for i, (case, (cross, mask)) in enumerate(MHA_CASES.items()):
        pt.seed(10 + i)
        layer = jnn.MultiHeadAttention(E, H, kdim=KDIM if cross else None,
                                       vdim=VDIM if cross else None)
        layer.eval()
        f = _jit(layer)
        args = (q, *kv) if cross else (q, None, None)
        args += (None if mask is None else masks[mask],)
        params = jnn.state_arrays(layer)
        res = {"ref": _in_tier(False, lambda: f(params, *args))}
        if mask is None:
            res["interpret"] = _in_tier(True, lambda: f(params, *args))
        out[case] = (layer, args, res)
    return out


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_multi_head_attention_matches_jax(mha, case):
    jlayer, args, res = mha[case]
    cross = MHA_CASES[case][0]
    tl = _port(jlayer, tnn.MultiHeadAttention(
        E, H, kdim=KDIM if cross else None, vdim=VDIM if cross else None,
        device="cpu"))
    with torch.no_grad():
        got = tl(*(None if a is None else _t(a) for a in args))
    for tier, want in res.items():
        _close(got, want)


@pytest.fixture(scope="module")
def mha_cache():
    """A JAX layer per dtype: ``gen_cache``, then calls of 3 and 2 tokens
    through the cache (outputs and caches)."""
    x1, x2 = _x(4, B, 3, E), _x(5, B, 2, E)
    out = {}
    for dt in ("float32", "bfloat16"):
        pt.seed(20)
        layer = jnn.MultiHeadAttention(E, H)
        layer.eval()
        sd = {k: _np(v) for k, v in layer.state_dict().items()}
        layer = layer.to(dtype=dt)
        f = _jit(layer)
        params = jnn.state_arrays(layer)

        def two_calls(a, b):
            c0 = layer.gen_cache(pt.Tensor(a))
            c0 = (c0[0]._value, c0[1]._value)
            o1, c1 = f(params, a, a, a, None, c0)
            o2, c2 = f(params, b, b, b, None, c1)
            return o1, o2, c2
        cast = (lambda a: a) if dt == "float32" else \
            (lambda a: np.asarray(a).astype(jax.numpy.bfloat16))
        out[dt] = (sd, x1, x2, _in_tier(False,
                                        lambda: two_calls(cast(x1),
                                                          cast(x2))))
    return out


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mha_cache_path_matches_jax_and_promotes_to_fp32(mha_cache, dt):
    sd, x1, x2, (o1, o2, (k, v)) = mha_cache[dt]
    tl = tnn.MultiHeadAttention(E, H, device="cpu")
    tl.load_state_dict(state_dict_from_numpy(sd, device="cpu"))
    tl = tl.to(getattr(torch, dt)).eval()
    a, b = _t(x1, dt), _t(x2, dt)
    with torch.no_grad():
        c0 = tl.gen_cache(a)
        assert c0[0].dtype == torch.float32 and c0[0].shape == (B, 0, H,
                                                                E // H)
        g1, c1 = tl(a, a, a, None, c0)
        g2, (gk, gv) = tl(b, b, b, None, c1)
    assert {t.dtype for t in (g1, g2, gk, gv)} == {torch.float32}
    assert np.asarray(o2).dtype == np.float32 == np.asarray(k).dtype
    assert gk.shape == (B, 5, H, E // H)
    for got, want in ((g1, o1), (g2, o2), (gk, k), (gv, v)):
        _close(got, want, dt)


def test_head_dim_must_divide_embed_dim():
    with pytest.raises(AssertionError):
        jnn.MultiHeadAttention(30, 4)
    with pytest.raises(AssertionError):
        tnn.MultiHeadAttention(30, 4, device="cpu")


# ------------------------------------------------------------ the encoder
ENC_CASES = [(pre, act) for pre in (False, True) for act in ("relu", "gelu")]
ENC_IDS = [f"{'pre' if p else 'post'}-LN-{a}" for p, a in ENC_CASES]


def _enc_layer(mod, pre, act, **kw):
    return mod.TransformerEncoderLayer(E, H, FF, dropout=0.0, activation=act,
                                       normalize_before=pre, **kw)


@pytest.fixture(scope="module")
def enc_layers():
    x, mask = _x(6, B, S, E), _masks()["bool"]
    out = {}
    for i, (pre, act) in enumerate(ENC_CASES):
        pt.seed(30 + i)
        layer = _enc_layer(jnn, pre, act)
        layer.eval()
        f, params = _jit(layer), jnn.state_arrays(layer)
        c0 = (np.zeros((B, 0, H, E // H), np.float32),) * 2
        out[pre, act] = (layer, {
            "plain": _in_tier(False, lambda: f(params, x)),
            "interpret": _in_tier(True, lambda: f(params, x)),
            "mask": _in_tier(False, lambda: f(params, x, mask)),
            "cache": _in_tier(False, lambda: f(params, x, None, c0))})
    return x, mask, out


@pytest.mark.parametrize("pre,act", ENC_CASES, ids=ENC_IDS)
def test_encoder_layer_matches_jax(enc_layers, pre, act):
    x, mask, out = enc_layers
    jlayer, res = out[pre, act]
    tl = _port(jlayer, _enc_layer(tnn, pre, act, device="cpu"))
    c0 = (torch.zeros(B, 0, H, E // H),) * 2
    with torch.no_grad():
        plain = tl(_t(x))
        masked = tl(_t(x), _t(mask))
        cached, (k, v) = tl(_t(x), None, c0)
    _close(plain, res["plain"])
    _close(plain, res["interpret"])
    _close(masked, res["mask"])
    _close(cached, res["cache"][0])
    _close(k, res["cache"][1][0])
    _close(v, res["cache"][1][1])


@pytest.fixture(scope="module")
def encoder_grads():
    """A 2-layer pre-LN gelu encoder with a final norm: output and the
    gradients of ``sum(out * w)`` in every parameter and the input, in the
    reference tier and under interpret mode."""
    x, w = _x(8, B, S, E), _x(9, B, S, E)
    pt.seed(40)
    enc = jnn.TransformerEncoder(_enc_layer(jnn, True, "gelu"), 2,
                                 jnn.LayerNorm(E))
    enc.train()
    params = jnn.state_arrays(enc)
    f = _jit(enc)

    def loss(p, xv):
        out = f(p, xv)
        return (out * w).sum(), out
    vg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    res = {tier: _in_tier(tier == "interpret", lambda: vg(params, x))
           for tier in ("reference", "interpret")}
    return enc, x, w, res


@pytest.mark.parametrize("tier", ["reference", "interpret"])
def test_encoder_stack_output_and_grads_match_jax(encoder_grads, tier):
    jenc, x, w, res = encoder_grads
    (_, want_out), (want_g, want_gx) = res[tier]
    tenc = tnn.TransformerEncoder(_enc_layer(tnn, True, "gelu",
                                             device="cpu"), 2,
                                  tnn.layer.LayerNorm(E, device="cpu"))
    tenc = _port(jenc, tenc).train()
    xt = _t(x).requires_grad_()
    out = tenc(xt)
    (out * _t(w)).sum().backward()
    _close(out, want_out)
    _close(xt.grad, want_gx)
    grads = {k: p.grad for k, p in tenc.named_parameters()}
    assert sorted(grads) == sorted(want_g)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), _np(want_g[k]), err_msg=k,
                                   **TOL["float32"])


# ------------------------------------------- decoder and the Transformer
@pytest.fixture(scope="module")
def transformers():
    src, tgt = _x(11, B, S, E), _x(12, B, T, E)
    jmask = jnn.Transformer.generate_square_subsequent_mask(T)
    out = {}
    for pre in (False, True):
        pt.seed(50 + pre)
        net = jnn.Transformer(E, H, 2, 2, FF, dropout=0.0,
                              normalize_before=pre)
        net.eval()
        out[pre] = (net, _in_tier(False, lambda: _jit(net)(
            jnn.state_arrays(net), src, tgt, None, jmask._value)))
    return src, tgt, _np(jmask._value), out


@pytest.mark.parametrize("pre", [False, True], ids=["post-LN", "pre-LN"])
def test_transformer_with_subsequent_mask_matches_jax(transformers, pre):
    src, tgt, jmask, out = transformers
    jnet, want = out[pre]
    mask = tnn.Transformer.generate_square_subsequent_mask(T, device="cpu")
    assert mask.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), jmask)
    tnet = _port(jnet, tnn.Transformer(E, H, 2, 2, FF, dropout=0.0,
                                       normalize_before=pre, device="cpu"))
    assert (tnet.encoder.norm is None) == (not pre)
    with torch.no_grad():
        got = tnet(_t(src), _t(tgt), None, mask)
    _close(got, want)


# -------------------------------------------------- copies and routing
def test_deep_copied_layers_start_equal_and_draw_different_masks():
    gen = torch.Generator().manual_seed(0)
    layer = tnn.TransformerEncoderLayer(E, H, FF, dropout=0.5,
                                        generator=gen, device="cpu")
    enc = tnn.TransformerEncoder(layer, 3).train()
    a, b, c = enc.layers
    assert a is layer
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]) and \
            torch.equal(v, c.state_dict()[k])
    assert b.linear1.weight.data_ptr() != a.linear1.weight.data_ptr()
    for lay in (b, c):
        assert lay.dropout1.generator is gen
        assert lay.self_attn.generator is gen
    x = torch.ones(B, S, E)
    masks = [lay.dropout1(x) == 0 for lay in (a, b, c)]
    assert not torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[1], masks[2])


def test_attention_takes_flash_exactly_where_jax_routes_to_it(monkeypatch):
    """The dense chain under a mask or training dropout is the JAX routing
    rule (``attention.py:62-71``), not a fallback."""
    taken = []
    flash, dense = TF.flash_attention, TF._sdpa_ref
    monkeypatch.setattr(TF, "flash_attention", lambda *a, **k: (
        taken.append("flash"), flash(*a, **k))[1])
    monkeypatch.setattr(TF, "_sdpa_ref", lambda *a, **k: (
        taken.append("dense"), dense(*a, **k))[1])
    mha = tnn.MultiHeadAttention(E, H, dropout=0.1, device="cpu")
    x = torch.from_numpy(_x(13, B, S, E))
    mask = torch.from_numpy(_masks()["bool"])
    routes = {}
    for name, train, m in (("eval", False, None), ("eval mask", False, mask),
                           ("train dropout", True, None),
                           ("train mask", True, mask)):
        taken.clear()
        mha.train(train)(x, attn_mask=m)
        routes[name] = list(taken)
    mha.dropout = 0.0
    taken.clear()
    mha.train()(x)
    routes["train no dropout"] = list(taken)
    assert routes == {"eval": ["flash"], "eval mask": ["dense"],
                      "train dropout": ["dense"], "train mask": ["dense"],
                      "train no dropout": ["flash"]}


def test_jax_eager_adamw_updates_one_of_two_copies_the_port_both():
    """A documented divergence (ROADMAP queue 3): the JAX eager optimizer
    keys parameters by ``p.name`` (``optimizer.py:217-219``), which
    ``copy.deepcopy`` copies, so the deep-copied layers of
    ``TransformerEncoder`` share names and its step moves only the last
    copy; the port's ``AdamW`` moves every layer."""
    from paddle_tpu_torch.optimizer import AdamW
    pt.seed(60)
    jenc = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
        8, 2, 16, dropout=0.0), 2)
    names = [[p.name for p in lay.parameters()] for lay in jenc.layers]
    assert names[0] == names[1]
    x = pt.to_tensor(_x(14, 1, 3, 8))
    before = {k: _np(v) for k, v in jenc.state_dict().items()}
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=jenc.parameters())
    (jenc(x) * pt.to_tensor(_x(15, 1, 3, 8))).sum().backward()
    opt.step()
    moved = {k for k, v in jenc.state_dict().items()
             if not np.array_equal(_np(v), before[k])}
    assert moved and all(k.startswith("layers.1.") for k in moved)

    tenc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        8, 2, 16, dropout=0.0, device="cpu"), 2)
    tenc.load_state_dict(state_dict_from_numpy(before, device="cpu"))
    opt = AdamW(learning_rate=1e-3, parameters=tenc.named_parameters())
    (tenc(torch.from_numpy(_x(14, 1, 3, 8))) * torch.from_numpy(
        _x(15, 1, 3, 8))).sum().backward()
    opt.step()
    moved = {k for k, v in tenc.state_dict().items()
             if not torch.equal(v, torch.from_numpy(before[k]))}
    assert any(k.startswith("layers.0.") for k in moved)
    assert any(k.startswith("layers.1.") for k in moved)


def test_layers_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a CUDA device")
    for make in (lambda: tnn.MultiHeadAttention(E, H),
                 lambda: tnn.TransformerEncoderLayer(E, H, FF),
                 lambda: tnn.Transformer(E, H, 1, 1, FF),
                 lambda: tnn.Transformer.generate_square_subsequent_mask(T)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
