"""The port's BERT (``paddle_tpu_torch.models.bert``) against the JAX
package's ``paddle_tpu/models/bert.py``.

``bert_tiny`` (V 256, H 64, 2 layers, 4 heads, FFN 128) with both
dropouts at 0, batch 2 x 16 from numpy seed 0.  Each JAX model is built
once per module after ``pt.seed``; its ``state_dict()`` goes to the port
through ``bridge.state_dict_from_numpy``.  The JAX reference tier (the
dense ``_sdpa_ref`` chain on the CPU) gives, at fp32 1e-5 (relative and
absolute):

* ``BertModel``'s sequence and pooled outputs without a mask, and with
  token types and a 2-D pad mask (the last 5 tokens of row 1 padded);
* the classifier's loss and every gradient, and two ``AdamW(1e-3,
  weight_decay=0)`` steps (the bench's optimizer): both losses, and the
  params after them where the first gradient exceeds 1e-7 (elsewhere
  each side is held to the AdamW rule replayed in numpy on its own
  gradients, as in ``test_torch_eager_models.py``);
* ``BertForPretraining``'s MLM / NSP logits and its loss with -100
  labels.

Without a mask and without dropout the JAX path reaches flash on the TPU,
so the unmasked outputs, loss and gradients are also held to the JAX
model under ``pallas_interpret`` (the Pallas flash kernels in interpret
mode).  Also: the ``state_dict`` keys (in order) are the JAX ones; the
bf16 model's logits are within 2e-2 of the JAX bf16 model's; the padding
does not reach unpadded positions; the presets equal JAX's; the models
default to CUDA; ``ParamAttr`` arguments raise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.core.flags import FLAGS, set_flags
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.bridge import state_dict_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.optimizer import AdamW

B, S, LR, STEPS, PAD = 2, 16, 1e-3, 2, 5
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
FP32 = dict(rtol=1e-5, atol=1e-5)


def _np(v):
    return np.array(np.asarray(v), dtype=np.float32, copy=True)


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (B, S))
    types = rng.integers(0, 2, (B, S))
    labels = rng.integers(0, 2, (B,))
    mask = np.ones((B, S), np.int64)
    mask[1, -PAD:] = 0
    mlm = np.where(rng.random((B, S)) < 0.3, ids, -100)
    return dict(ids=ids, types=types, labels=labels, mask=mask, mlm=mlm,
                nsp=rng.integers(0, 2, (B,)))


def _jit(net, method=None):
    """``net`` (or ``method`` of it, called on ``net``'s parameter names)
    as one jitted function of ``(params, *args)``: a JAX program per call
    signature instead of an eager dispatch per op."""
    def call(params, *args, **kw):
        t = [None if a is None else pt.Tensor(a) for a in args]
        with jnn.functional_state(net, params):
            out = (method or net)(*t, **kw)
        return jax.tree_util.tree_map(
            lambda v: v._value, out,
            is_leaf=lambda v: isinstance(v, pt.Tensor))
    return call


def _jax_classifier_run(interpret=False):
    """The JAX classifier's initial state_dict, ``BertModel`` outputs
    (unmasked; with types and the pad mask), eval logits, first loss and
    gradients, and the losses, gradients and final parameters over STEPS
    AdamW steps (``apply_gradients``, the update of the eager step keyed
    by the parameters' paths); with ``interpret`` under
    ``pallas_interpret`` (no pad mask), without the optimizer steps."""
    b = _batch()
    pt.seed(0)
    net = jbert.BertForSequenceClassification(jbert.bert_tiny(**NO_DROPOUT),
                                              2)
    params = jnn.state_arrays(net)
    out = dict(sd0={k: _np(v) for k, v in params.items()})
    old = FLAGS.pallas_interpret
    set_flags({"pallas_interpret": interpret})
    try:
        net.eval()
        bert = _jit(net, net.bert)
        fwd = jax.jit(lambda p, i, t, m: (bert(p, i), bert(p, i, t, m),
                                          _jit(net)(p, i, t, m)))
        (seq, pooled), (seq_m, pooled_m), logits = fwd(
            params, b["ids"], b["types"], b["mask"])
        out.update(seq=_np(seq), pooled=_np(pooled), seq_m=_np(seq_m),
                   pooled_m=_np(pooled_m), logits=_np(logits))
        net.train()
        loss_fn = _jit(net)
        vg = jax.jit(jax.value_and_grad(
            lambda p, i, y: loss_fn(p, i, labels=y)))
        opt = pt.optimizer.AdamW(learning_rate=LR, weight_decay=0.0)
        state = opt.init_state(params)
        apply = jax.jit(opt.apply_gradients)
        losses, grads_steps = [], []
        for step in range(1, 1 + (1 if interpret else STEPS)):
            loss, grads = vg(params, b["ids"], b["labels"])
            losses.append(float(loss))
            grads_steps.append({k: _np(v) for k, v in grads.items()})
            params, state = apply(params, grads, state, LR, step)
    finally:
        set_flags({"pallas_interpret": old})
    out.update(losses=losses, grads=grads_steps[0], grads_steps=grads_steps,
               final={k: _np(v) for k, v in params.items()})
    if not interpret:
        net16 = net.to(dtype="bfloat16")
        net16.eval()
        out["logits16"] = _np(jax.jit(_jit(net16))(
            jnn.state_arrays(net16), b["ids"], b["types"],
            b["mask"]).astype(np.float32))
    return out


def _jax_pretraining_run():
    b = _batch()
    pt.seed(1)
    net = jbert.BertForPretraining(jbert.bert_tiny(**NO_DROPOUT))
    net.eval()
    params = jnn.state_arrays(net)
    f = _jit(net)
    (mlm, nsp), loss, mlm_loss = jax.jit(lambda p: (
        f(p, b["ids"], b["types"], b["mask"]),
        f(p, b["ids"], b["types"], b["mask"], b["mlm"], b["nsp"]),
        f(p, b["ids"], b["types"], b["mask"], b["mlm"])))(params)
    return dict(sd0={k: _np(v) for k, v in params.items()},
                mlm=_np(mlm), nsp=_np(nsp), loss=float(loss),
                mlm_loss=float(mlm_loss))


@pytest.fixture(scope="module")
def run():
    return _jax_classifier_run()


@pytest.fixture(scope="module")
def interpret():
    return _jax_classifier_run(interpret=True)


@pytest.fixture(scope="module")
def pretraining():
    return _jax_pretraining_run()


def _port(sd0, cls=tbert.BertForSequenceClassification, cast=None):
    net = cls(tbert.bert_tiny(**NO_DROPOUT), device="cpu")
    net.load_state_dict(state_dict_from_numpy(sd0, device="cpu"))
    return net if cast is None else net.to(cast)


def _t():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


def _loss_and_grads(net):
    t = _t()
    loss = net(t["ids"], labels=t["labels"])
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy().copy()
                                  for k, p in net.named_parameters()}


def _adamw_rule(p0, grads, lr=LR, b1=0.9, b2=0.999, eps=1e-8):
    """fp32 numpy replay of ``AdamW`` at ``weight_decay=0``, the bias
    corrections ``1 - b^t`` in fp32 as both updates take them (at lr 1e-3
    the gradients near ``epsilon`` feel their rounding)."""
    f = np.float32
    p, m, v = p0.astype(f), np.zeros_like(p0, f), np.zeros_like(p0, f)
    for t, g in enumerate(grads, 1):
        m = f(b1) * m + f(1 - b1) * g
        v = f(b2) * v + f(1 - b2) * np.square(g)
        mhat = m / (f(1) - f(b1) ** f(t))
        vhat = v / (f(1) - f(b2) ** f(t))
        p = p - f(lr) * (mhat / (np.sqrt(vhat) + f(eps)))
    return p


@pytest.mark.parametrize("cls,fixture", [
    (tbert.BertForSequenceClassification, "run"),
    (tbert.BertForPretraining, "pretraining")],
    ids=["classifier", "pretraining"])
def test_state_dict_keys_are_the_jax_ones(cls, fixture, request):
    sd0 = request.getfixturevalue(fixture)["sd0"]
    net = _port(sd0, cls)
    assert list(net.state_dict()) == list(sd0)
    for k, v in net.state_dict().items():
        assert tuple(v.shape) == sd0[k].shape, k


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "types-mask"])
def test_bert_model_outputs_match_jax(run, masked):
    net = _port(run["sd0"]).eval()
    t = _t()
    with torch.no_grad():
        seq, pooled = net.bert(t["ids"], t["types"], t["mask"]) if masked \
            else net.bert(t["ids"])
    sfx = "_m" if masked else ""
    np.testing.assert_allclose(seq.numpy(), run["seq" + sfx], **FP32)
    np.testing.assert_allclose(pooled.numpy(), run["pooled" + sfx], **FP32)
    if masked:
        with torch.no_grad():
            logits = net(t["ids"], t["types"], t["mask"])
        np.testing.assert_allclose(logits.numpy(), run["logits"], **FP32)


def test_unmasked_outputs_match_jax_interpret_tier(interpret):
    net = _port(interpret["sd0"]).eval()
    with torch.no_grad():
        seq, pooled = net.bert(_t()["ids"])
    np.testing.assert_allclose(seq.numpy(), interpret["seq"], **FP32)
    np.testing.assert_allclose(pooled.numpy(), interpret["pooled"], **FP32)


@pytest.mark.parametrize("tier", ["reference", "interpret"])
def test_classifier_loss_and_every_grad_match_jax(run, interpret, tier):
    want = run if tier == "reference" else interpret
    loss, grads = _loss_and_grads(_port(want["sd0"]))
    np.testing.assert_allclose(loss, want["losses"][0], **FP32)
    assert sorted(grads) == sorted(want["grads"])
    for k, g in grads.items():
        np.testing.assert_allclose(g, want["grads"][k], err_msg=k, **FP32)


def test_two_adamw_steps_match_jax(run):
    net = _port(run["sd0"])
    opt = AdamW(learning_rate=LR, weight_decay=0.0,
                parameters=net.named_parameters())
    t = _t()
    losses, grads_steps = [], []
    for _ in range(STEPS):
        loss = net(t["ids"], labels=t["labels"])
        loss.backward()
        grads_steps.append({k: p.grad.numpy().copy()
                            for k, p in net.named_parameters()})
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, run["losses"], **FP32)
    tight = dict(rtol=1e-6, atol=1e-9)
    for k, p in net.state_dict().items():
        got, want, p0 = p.numpy(), run["final"][k], run["sd0"][k]
        live = np.abs(run["grads"][k]) > 1e-7
        np.testing.assert_allclose(got[live], want[live], err_msg=k, **FP32)
        mine = _adamw_rule(p0, [g[k] for g in grads_steps])
        ref = _adamw_rule(p0, [g[k] for g in run["grads_steps"]])
        np.testing.assert_allclose(got[~live], mine[~live], err_msg=k,
                                   **tight)
        np.testing.assert_allclose(want[~live], ref[~live], err_msg=k,
                                   **tight)


def test_pretraining_logits_and_loss_match_jax(pretraining):
    net = _port(pretraining["sd0"], tbert.BertForPretraining).eval()
    t = _t()
    with torch.no_grad():
        mlm, nsp = net(t["ids"], t["types"], t["mask"])
        loss = net(t["ids"], t["types"], t["mask"], mlm_labels=t["mlm"],
                   nsp_labels=t["nsp"])
        mlm_loss = net(t["ids"], t["types"], t["mask"], mlm_labels=t["mlm"])
    assert mlm.shape == (B, S, 256) and nsp.shape == (B, 2)
    assert (t["mlm"] == -100).any() and (t["mlm"] != -100).any()
    np.testing.assert_allclose(mlm.numpy(), pretraining["mlm"], **FP32)
    np.testing.assert_allclose(nsp.numpy(), pretraining["nsp"], **FP32)
    np.testing.assert_allclose(float(loss), pretraining["loss"], **FP32)
    np.testing.assert_allclose(float(mlm_loss), pretraining["mlm_loss"],
                               **FP32)


def test_bf16_logits_match_jax(run):
    net = _port(run["sd0"], cast=torch.bfloat16).eval()
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    t = _t()
    with torch.no_grad():
        logits = net(t["ids"], t["types"], t["mask"])
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(), run["logits16"],
                               rtol=2e-2, atol=2e-2)


def test_padding_does_not_reach_unpadded_positions(run):
    """``tests/test_models.py``'s pad check on the port: other ids under
    the pad mask leave the unpadded positions' outputs as they were."""
    net = _port(run["sd0"]).eval()
    t = _t()
    ids2 = t["ids"].clone()
    ids2[1, -PAD:] = 1
    with torch.no_grad():
        a, _ = net.bert(t["ids"], None, t["mask"])
        b, _ = net.bert(ids2, None, t["mask"])
    torch.testing.assert_close(a[:, :-PAD], b[:, :-PAD], rtol=0, atol=1e-5)
    assert not torch.allclose(a[1, -PAD:], b[1, -PAD:])


@pytest.mark.parametrize("name", ["bert_tiny", "bert_base", "bert_large"])
def test_presets_equal_jax(name):
    got = dataclasses.asdict(getattr(tbert, name)())
    assert got == dataclasses.asdict(getattr(jbert, name)())
    assert dataclasses.asdict(getattr(tbert, name)(num_layers=3)) == \
        dataclasses.asdict(getattr(jbert, name)(num_layers=3))


def test_dropout_masks_come_from_the_generator():
    """With dropout 0.1 a train step draws its masks from the model's
    generator: one seed gives one loss, another seed another."""
    ids = torch.from_numpy(_batch()["ids"])
    labels = torch.tensor([0, 1])
    nets = [tbert.BertForSequenceClassification(
        tbert.bert_tiny(), generator=torch.Generator().manual_seed(s),
        device="cpu") for s in (3, 3, 4)]
    for n in nets[1:]:
        n.load_state_dict(nets[0].state_dict())
    a, b, c = (n(ids, labels=labels) for n in nets)
    assert torch.isfinite(a) and torch.equal(a, b) and not torch.equal(a, c)


def test_models_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a CUDA device")
    for cls in (tbert.BertModel, tbert.BertForSequenceClassification,
                tbert.BertForPretraining):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(tbert.bert_tiny())


@pytest.mark.parametrize("field", ["weight_attr", "bias_attr"])
def test_param_attr_arguments_raise(field):
    from paddle_tpu_torch.nn.layer import Linear
    from paddle_tpu_torch.nn.transformer import TransformerEncoderLayer
    attr = pt.ParamAttr(name="w")
    with pytest.raises(NotImplementedError, match="item 20"):
        Linear(4, 4, **{field: attr}, device="cpu")
    with pytest.raises(NotImplementedError, match="item 20"):
        TransformerEncoderLayer(8, 2, 16, **{field: attr}, device="cpu")
    assert Linear(4, 4, None, False, device="cpu").bias is None
