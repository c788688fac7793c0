"""The port's incubate fused layers and calls (``paddle_tpu_torch.incubate.
nn``) against the JAX package's (``paddle_tpu.incubate.nn``).

d_model 64, 4 heads (head_dim 16), FFN 128, tanh GELU, batch 2 x 8.  Each
JAX stack is built once per module after ``pt.seed(0)`` and run in eval;
its ``state_dict()`` goes to the port through
``bridge.state_dict_from_numpy``, and the port's inputs are copies of the
same numpy arrays.  The JAX stacks run under
``set_flags({"pallas_interpret": True})`` (restored after), so they take
their TPU structure: the Pallas flash, bias-residual LayerNorm,
bias-activation and dropout-add kernels in interpret mode.
Tolerances: fp32 1e-5, bf16 2e-2 (relative and absolute).

* A 2-layer stack of ``FusedTransformerEncoderLayer``, post-LN and pre-LN,
  fp32 and bf16 (the JAX layers cast with ``.to(dtype="bfloat16")``):
  the first layer's ``FusedMultiHeadAttention`` and ``FusedFeedForward``
  outputs and the stack's output.
* ``FusedLinear`` (both weight layouts), ``FusedBiasDropoutResidualLayer
  Norm``, ``FusedDropoutAdd`` and ``FusedDropout`` in eval; in training
  the port's dropout layers are held by their properties (JAX's masks
  come from its own generator).
* ``fused_multi_head_attention`` in its ``[3, H, D, E]`` layout (post-LN)
  and with ``transpose_qkv_wb`` (``[E, 3E]``, pre-LN, an additive mask),
  ``fused_feedforward`` pre-LN relu and post-LN GELU with
  ``downscale_in_infer``, ``fused_linear_activation``,
  ``fused_matmul_bias`` and ``fused_layer_norm``.
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

B, S, E, H, FF, LAYERS = 2, 8, 64, 4, 128, 2
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CONFIGS = [(False, "float32"), (True, "float32"), (False, "bfloat16"),
           (True, "bfloat16")]
CONFIG_IDS = ["post-LN-fp32", "pre-LN-fp32", "post-LN-bf16", "pre-LN-bf16"]


def _np(v):
    return np.array(np.asarray(v), dtype=np.float32, copy=True)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, dt):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               **TOL[dt])


def _jx(a, dt):
    return pt.to_tensor(a).astype(dt)


def _tx(a, dt):
    return torch.from_numpy(np.array(a, copy=True)).to(TDT[dt])


@pytest.fixture(scope="module", params=CONFIGS, ids=CONFIG_IDS)
def stack(request):
    """The JAX stack's state_dicts and eval outputs for one configuration:
    the first layer's attention and FFN outputs and the stack's."""
    pre, dt = request.param
    old = FLAGS.pallas_interpret
    set_flags({"pallas_interpret": True})
    request.addfinalizer(lambda: set_flags({"pallas_interpret": old}))
    pt.seed(0)
    layers = [jinc.FusedTransformerEncoderLayer(
        E, H, FF, activation="gelu", normalize_before=pre)
        for _ in range(LAYERS)]
    x = _x(0, B, S, E)
    for layer in layers:
        layer.eval()
        if dt == "bfloat16":
            layer.to(dtype="bfloat16")
    h = layers[0].fused_attn(_jx(x, dt))
    outs = [_np(h.astype("float32").numpy())]
    h = layers[0].ffn(h)
    for layer in layers[1:]:
        h = layer(h)
    outs.append(_np(h.astype("float32").numpy()))
    return dict(pre=pre, dt=dt, x=x, outs=outs,
                sds=[{k: np.asarray(v) for k, v in layer.state_dict().items()}
                     for layer in layers])


def _port_stack(run):
    layers = torch.nn.ModuleList(
        tinc.FusedTransformerEncoderLayer(E, H, FF, activation="gelu",
                                          normalize_before=run["pre"],
                                          device="cpu")
        for _ in range(LAYERS))
    for layer, sd in zip(layers, run["sds"]):
        assert set(layer.state_dict()) == set(sd)
        layer.load_state_dict(state_dict_from_numpy(sd, device="cpu"))
    return layers.to(TDT[run["dt"]]).eval()


def test_encoder_stack_matches_jax(stack):
    layers = _port_stack(stack)
    dt = stack["dt"]
    with torch.no_grad():
        h = layers[0].fused_attn(_tx(stack["x"], dt))
        assert h.dtype == TDT[dt]
        _close(h, stack["outs"][0], dt)
        h = layers[0].ffn(h)
        for layer in layers[1:]:
            h = layer(h)
    assert h.dtype == TDT[dt]
    _close(h, stack["outs"][1], dt)


def test_encoder_layer_trains_with_generator_masks():
    """train(): attention dropout takes the dense chain and both dropouts
    draw from the layer's generator; one seed, one output."""
    def run(seed):
        g = torch.Generator().manual_seed(seed)
        layer = tinc.FusedTransformerEncoderLayer(
            E, H, FF, dropout_rate=0.1, activation="gelu",
            normalize_before=True, generator=g, device="cpu")
        return layer(_tx(_x(1, B, S, E), "float32"))
    a, b, c = run(3), run(3), run(4)
    assert torch.isfinite(a).all() and a.shape == (B, S, E)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear_matches_jax(transpose):
    pt.seed(1)
    j = jinc.FusedLinear(16, 24, transpose_weight=transpose)
    t = tinc.FusedLinear(16, 24, transpose_weight=transpose, device="cpu")
    t.load_state_dict(state_dict_from_numpy(j.state_dict(), device="cpu"))
    x = _x(2, 3, 16)
    _close(t(torch.from_numpy(x)), j(pt.to_tensor(x)).numpy(), "float32")


def test_bias_dropout_residual_layer_norm_matches_jax():
    pt.seed(2)
    j = jinc.FusedBiasDropoutResidualLayerNorm(E, dropout_rate=0.3)
    t = tinc.FusedBiasDropoutResidualLayerNorm(E, dropout_rate=0.3,
                                               device="cpu")
    sd = {k: _x(3 + i, *np.shape(v)) for i, (k, v) in
          enumerate(j.state_dict().items())}
    j.set_state_dict({k: pt.to_tensor(v) for k, v in sd.items()})
    t.load_state_dict(state_dict_from_numpy(sd, device="cpu"))
    j.eval()
    t.eval()
    x, r = _x(4, B, S, E), _x(5, B, S, E)
    _close(t(torch.from_numpy(x), torch.from_numpy(r)),
           j(pt.to_tensor(x), pt.to_tensor(r)).numpy(), "float32")


def test_dropout_layers_match_jax_in_eval_and_hold_in_training():
    x, y = _x(6, 16, 32), _x(7, 16, 32)
    jd, jda = jinc.FusedDropout(0.4), jinc.FusedDropoutAdd(0.4)
    jd.eval()
    jda.eval()
    g = torch.Generator().manual_seed(0)
    td = tinc.FusedDropout(0.4, generator=g).eval()
    tda = tinc.FusedDropoutAdd(0.4, generator=g).eval()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    _close(td(tx), jd(pt.to_tensor(x)).numpy(), "float32")
    np.testing.assert_array_equal(
        tda(tx, ty).numpy(), jda(pt.to_tensor(x), pt.to_tensor(y)).numpy())
    td.train()
    tda.train()
    scale = np.float32(1 / 0.6)
    out = td(tx).numpy()
    kept = out != 0
    np.testing.assert_allclose(out[kept], (x / 0.6)[kept], rtol=1e-6)
    d = (tda(tx, ty) - ty).numpy()
    kept = np.abs(d - x * scale) < 1e-5
    assert (kept | (np.abs(d) < 1e-6)).all()
    assert abs(kept.mean() - 0.6) < 5 * np.sqrt(0.24 / x.size)
    with pytest.raises(NotImplementedError, match="item 17"):
        tinc.FusedDropout(0.4, axis=1)


def _mha_inputs(transpose):
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((E, 3 * E)) if transpose else
         rng.standard_normal((3, H, E // H, E))) * 0.1
    vecs = {n: rng.standard_normal(s) * 0.1 for n, s in (
        ("qkv_bias", (3 * E,) if transpose else (3, H, E // H)),
        ("pre_ln_scale", (E,)), ("pre_ln_bias", (E,)), ("ln_scale", (E,)),
        ("ln_bias", (E,)), ("linear_bias", (E,)))}
    vecs["pre_ln_scale"] += 1
    vecs["ln_scale"] += 1
    arrs = dict(x=_x(9, B, S, E), qkv_weight=w,
                linear_weight=rng.standard_normal((E, E)) * 0.1, **vecs)
    return {k: np.asarray(v, np.float32) for k, v in arrs.items()}


@pytest.mark.parametrize("transpose,pre", [(False, False), (True, True)],
                         ids=["3HDE-post-LN", "E3E-pre-LN-mask"])
def test_fused_multi_head_attention_matches_jax(transpose, pre):
    a = _mha_inputs(transpose)
    mask = np.where(_x(10, B, 1, S, S) > 1.0, -1e4, 0.0).astype(np.float32)
    kw = dict(pre_layer_norm=pre, transpose_qkv_wb=transpose,
              num_heads=H if transpose else -1, training=False)
    names = ("pre_ln_scale", "pre_ln_bias", "ln_scale", "ln_bias",
             "qkv_bias", "linear_bias")
    want = jIF.fused_multi_head_attention(
        *(pt.to_tensor(a[n]) for n in ("x", "qkv_weight", "linear_weight")),
        attn_mask=pt.to_tensor(mask) if pre else None,
        **{n: pt.to_tensor(a[n]) for n in names}, **kw).numpy()
    got = tIF.fused_multi_head_attention(
        *(torch.from_numpy(a[n]) for n in ("x", "qkv_weight",
                                           "linear_weight")),
        attn_mask=torch.from_numpy(mask) if pre else None,
        **{n: torch.from_numpy(a[n]) for n in names}, **kw)
    _close(got, want, "float32")


@pytest.mark.parametrize("pre,act,mode", [
    (True, "relu", "upscale_in_train"),
    (False, "gelu", "downscale_in_infer")])
def test_fused_feedforward_matches_jax(pre, act, mode):
    rng = np.random.default_rng(11)
    a = dict(x=_x(12, B, S, E),
             linear1_weight=rng.standard_normal((E, FF)) * 0.1,
             linear2_weight=rng.standard_normal((FF, E)) * 0.1,
             linear1_bias=rng.standard_normal(FF) * 0.1,
             linear2_bias=rng.standard_normal(E) * 0.1,
             ln1_scale=rng.standard_normal(E) * 0.1 + 1,
             ln1_bias=rng.standard_normal(E) * 0.1,
             ln2_scale=rng.standard_normal(E) * 0.1 + 1,
             ln2_bias=rng.standard_normal(E) * 0.1)
    a = {k: np.asarray(v, np.float32) for k, v in a.items()}
    kw = dict(dropout1_rate=0.2, dropout2_rate=0.3, activation=act,
              pre_layer_norm=pre, training=False, mode=mode)
    want = jIF.fused_feedforward(
        *(pt.to_tensor(v) for v in a.values()), **kw).numpy()
    got = tIF.fused_feedforward(*(torch.from_numpy(v) for v in a.values()),
                                **kw)
    _close(got, want, "float32")


def test_fused_linear_calls_match_jax():
    """``fused_linear_activation`` (the product, then kernel 18),
    ``fused_matmul_bias`` and ``fused_layer_norm`` with a bias and a
    residual (kernel 13)."""
    x, w, b, r = _x(13, B, S, E), _x(14, FF, E), _x(15, FF), _x(16, B, S, E)
    j = pt.to_tensor
    t = torch.from_numpy
    _close(tIF.fused_linear_activation(t(x), t(w), t(b), trans_y=True),
           jIF.fused_linear_activation(j(x), j(w), j(b),
                                       trans_y=True).numpy(), "float32")
    for a, y, bias, kw in ((x[0], x[1], b[:E], dict(transpose_x=True)),
                           (x[0], w, b, dict(transpose_y=True))):
        _close(tIF.fused_matmul_bias(t(a), t(y), t(bias), **kw),
               jIF.fused_matmul_bias(j(a), j(y), j(bias), **kw).numpy(),
               "float32")
    gain, lb = x[1, 0] * 0.1 + 1, x[1, 1] * 0.1
    want = jIF.fused_layer_norm(j(x), j(gain), j(lb), bias=j(b[:E]),
                                residual=j(r))
    got = tIF.fused_layer_norm(t(x), t(gain), t(lb), bias=t(b[:E]),
                               residual=t(r))
    for g, w_ in zip(got, want):
        _close(g, w_.numpy(), "float32")


def test_unported_options_raise():
    with pytest.raises(NotImplementedError,
                       match="cache_kv goes through masked_multihead"):
        tIF.fused_multi_head_attention(
            torch.zeros(1, 2, 8), torch.zeros(3, 2, 4, 8),
            torch.zeros(8, 8), cache_kv=torch.zeros(1))
    with pytest.raises(NotImplementedError, match="item 20"):
        tinc.FusedMultiHeadAttention(8, 2, qkv_weight_attr=object(),
                                     device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        tinc.FusedFeedForward(8, 16, nranks=2, device="cpu")
