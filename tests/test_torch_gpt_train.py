"""The port's one-device GPT train step against the JAX package's.

A 2-layer GPT (V 128, H 64, 4 heads of 16, P 64), b 2, s 32, fp32, flash
attention (the JAX interpret-mode kernels; the port's plain version),
remat, and the fused head at ``head_chunk`` 48 (uneven: 128 = 2 * 48 +
32), both steps started from one state carried over by
``bridge.state_from_numpy``:

* loss and every grad leaf of the port (``step_fn.loss_and_grads``)
  against the JAX step's own first gradient, read back from its Adam
  first moment after one step from zero moments (``m = (1 - b1) g``),
  1e-5;
* three steps: losses to relative 1e-5; params after step 3 within 2 *
  lr * steps everywhere and within 1e-6 on at least 99.9 % of the
  elements whose first gradient exceeds 1e-7 (Adam's first steps move a
  param by about lr * sign(g), which flips where g is rounding noise: the
  k third of ``qkv_b`` gets no gradient, since a bias shared by all keys
  leaves the softmax unchanged);
* the dense head and the dense attention compute the same function;
* under a bf16 config the head gets fp32 x (the fp32 final LayerNorm
  gains promote it) and the bf16 tied ``wte``, and the bridge keeps the
  fp32 ``lnf_*`` beside bf16 weights;
* every configuration outside the one-device step raises
  ``NotImplementedError`` naming its ROADMAP item.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import parallel as dist
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel.topology import HybridTopology, set_topology
from paddle_tpu_torch.bridge import params_from_numpy, state_from_numpy
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.parallel import train_step as tts

B, S, LR, STEPS, CHUNK = 2, 32, 1e-4, 3, 48
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX one-device step: its initial state, its state after one
    step (numpy), ids, its losses and its params after STEPS steps."""
    topo = dist.init_topology(devices=jax.devices()[:1])
    try:
        step, init = jgpt.build_gpt_train_step(
            jgpt.GPTConfig(**CFG), topo, num_microbatches=1,
            learning_rate=LR, use_flash=True, remat=True, head_chunk=CHUNK)
        state = init(0)

        def host(tree):
            return jax.tree.map(lambda a: np.array(a, copy=True),
                                jax.device_get(tree))
        state0 = host(state)
        rng = np.random.default_rng(0)
        ids = rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32)
        labels = np.roll(ids, -1, axis=1)
        losses = []
        for i in range(STEPS):
            state, loss = step(state, ids, labels)
            losses.append(float(loss))
            if i == 0:
                state1 = host(state)
        final = host(state["params"])
    finally:
        set_topology(HybridTopology())
    return dict(state0=state0, state1=state1, ids=ids, labels=labels,
                losses=losses, final=final)


def _leaves(tree):
    return [(k, tree[k]) for k in ("wte", "wpe", "lnf_w", "lnf_b")] + \
        sorted(tree["blocks"].items())


def test_loss_and_grads_match_jax_train_step(jax_run):
    step, _ = tts.build_gpt_train_step(tgpt.GPTConfig(**CFG), device="cpu",
                                       head_chunk=CHUNK)
    state = state_from_numpy(jax_run["state0"], device="cpu")
    loss, grads = step.loss_and_grads(state, jax_run["ids"],
                                      jax_run["labels"])
    np.testing.assert_allclose(float(loss), jax_run["losses"][0], rtol=1e-5)
    m1 = state_from_numpy(jax_run["state1"], device="cpu")["opt"]["m"]
    for (name, g), (_, m) in zip(_leaves(grads), _leaves(m1)):
        np.testing.assert_allclose(g.numpy(), m.numpy() / (1 - tts.ADAM_B1),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_three_steps_match_jax_train_step(jax_run):
    state = state_from_numpy(jax_run["state0"], device="cpu")
    step, _ = tts.build_gpt_train_step(tgpt.GPTConfig(**CFG), device="cpu",
                                       learning_rate=LR, head_chunk=CHUNK)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jax_run["ids"], jax_run["labels"])
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    assert losses[-1] < losses[0]
    ref = params_from_numpy(jax_run["final"], device="cpu")
    m1 = state_from_numpy(jax_run["state1"], device="cpu")["opt"]["m"]
    for (name, p), (_, r), (_, m) in zip(_leaves(state["params"]),
                                         _leaves(ref), _leaves(m1)):
        d = (p - r).abs()
        live = m.abs() / (1 - tts.ADAM_B1) > 1e-7
        assert float((d[live] <= 1e-6).float().mean()) >= 0.999, name
        assert float(d.max()) <= 2 * LR * STEPS, name


def test_dense_head_and_attention_agree():
    cfg = tgpt.GPTConfig(**CFG)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    labels = np.roll(ids, -1, axis=1)
    out = {}
    for fused, flash in ((True, True), (False, True), (True, False)):
        step, init = tts.build_gpt_train_step(
            cfg, device="cpu", fused_head=fused, use_flash=flash,
            head_chunk=CHUNK)
        out[fused, flash] = step.loss_and_grads(init(0), ids, labels)
    ref_loss, ref = out[True, True]
    for key, (loss, grads) in out.items():
        torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-5)
        for (name, g), (_, r) in zip(_leaves(grads), _leaves(ref)):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5,
                                       msg=f"{key} {name}")


def test_bf16_head_takes_fp32_x_and_the_bf16_tied_wte(jax_run, monkeypatch):
    tree = {k: v if k.startswith("lnf") or k == "blocks" else
            v.astype(ml_dtypes.bfloat16)
            for k, v in jax_run["state0"]["params"].items()}
    tree["blocks"] = {k: v.astype(ml_dtypes.bfloat16)
                      for k, v in tree["blocks"].items()}
    params = params_from_numpy(tree, device="cpu")
    assert params["lnf_w"].dtype == params["lnf_b"].dtype == torch.float32
    assert params["wte"].dtype == params["blocks"]["qkv_w"].dtype == \
        torch.bfloat16
    seen = []

    def record(x, w, labels, **kw):
        seen.append((x.dtype, w.dtype, kw["w_layout"]))
        return lce(x, w, labels, **kw)
    lce = tts.linear_cross_entropy
    monkeypatch.setattr(tts, "linear_cross_entropy", record)
    step, init = tts.build_gpt_train_step(
        tgpt.GPTConfig(dtype="bfloat16", **CFG), device="cpu")
    state = init(0)
    assert state["params"]["lnf_w"].dtype == torch.float32
    loss, grads = step.loss_and_grads(state, jax_run["ids"],
                                      jax_run["labels"])
    assert seen == [(torch.float32, torch.bfloat16, "vh")]
    assert torch.isfinite(loss)
    assert grads["wte"].dtype == torch.bfloat16
    assert grads["lnf_w"].dtype == torch.float32


REFUSED = {"moe": ({}, {"moe_num_experts": 4}),
           "dp": ({"dp": 2}, {}), "mp": ({"mp": 2}, {}),
           "pp": ({"pp": 2}, {}), "sep": ({"sep": 2}, {}),
           "sharding": ({"sharding": 2}, {}),
           "microbatches": ({"num_microbatches": 2}, {}),
           "cp-mode": ({"cp_mode": "ulysses"}, {}),
           "sequence-parallel": ({"sequence_parallel": True}, {}),
           "tp-overlap": ({"tp_overlap": True}, {}),
           "offload": ({"offload_optimizer": True}, {}),
           "stage3": ({"sharding_stage": 3}, {}),
           "remat-policy": ({"remat_policy": "dots"}, {})}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_configurations_raise(name):
    kw, cfg_kw = REFUSED[name]
    cfg = tgpt.gpt_tiny(**cfg_kw)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        tts.build_gpt_train_step(cfg, device="cpu", **kw)
