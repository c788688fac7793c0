"""The port's one-device Llama train step against the JAX package's.

At ``llama_tiny(num_layers=2, fused_head=False)`` with dynamic-NTK RoPE
(the tables are built at the step's length, 40 > 32 original positions),
b 2, s 40, fp32:

* loss and every grad leaf of the port (``step_fn.loss_and_grads``)
  against ``jax.value_and_grad`` of a loss built from the JAX
  ``block_apply`` with the interpret-mode Pallas flash attention, 1e-5;
* three steps of the port against the JAX ``build_llama_train_step`` on
  one device from one state carried over by ``bridge.state_from_numpy``:
  losses to relative 1e-5; params after step 3 within 1e-6 on at least
  99.9 % of the elements and within 2 * lr * steps everywhere (Adam's
  first steps move a param by about lr * sign(g), which flips where |g|
  is near eps);
* the same with the fused linear-CE head (``fused_head=True``, the
  config default; the JAX step runs the XLA tier of
  ``linear_cross_entropy`` on the CPU): loss and grads against the JAX
  step's own first gradient, read back from its Adam first moment, 1e-5;
  three steps as above;
* every configuration outside the one-device step raises
  ``NotImplementedError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import parallel as dist
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from paddle_tpu.parallel.topology import HybridTopology, set_topology
from paddle_tpu_torch.bridge import params_from_numpy, state_from_numpy
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.parallel.train_step import (ADAM_B1,
                                                  build_llama_train_step)

B, S, LR, STEPS = 2, 40, 1e-4, 3
ROPE = {"rope_type": "dynamic", "factor": 2.0,
        "original_max_position_embeddings": 32}


def _cfgs(**kw):
    kw = dict(dict(num_layers=2, fused_head=False, rope_scaling=ROPE), **kw)
    return jllama.llama_tiny(**kw), tllama.llama_tiny(**kw)


def _jax_steps(jcfg):
    """Run the JAX one-device step: its initial state and its state after
    one step (numpy), ids, its losses and its params after STEPS steps."""
    topo = dist.init_topology(devices=jax.devices()[:1])
    try:
        step, init = jllama.build_llama_train_step(
            jcfg, topo, num_microbatches=1, learning_rate=LR, use_flash=True,
            remat=True)
        state = init(0)

        def host(tree):
            return jax.tree.map(lambda a: np.array(a, copy=True),
                                jax.device_get(tree))
        state0 = host(state)
        rng = np.random.default_rng(0)
        ids = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
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


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step with the dense head."""
    return _jax_steps(_cfgs()[0])


@pytest.fixture(scope="module")
def jax_fused_run():
    """The JAX step with the fused head (the config default; the XLA tier
    of ``linear_cross_entropy`` on the CPU)."""
    return _jax_steps(_cfgs(fused_head=True)[0])


def _jax_loss(params, ids, labels, cfg):
    cos, sin = jllama._rope_cos_sin(S, cfg.head_dim, cfg.rope_theta,
                                    jnp.float32, cfg.rope_scaling)
    x = params["wte"][ids]
    for i in range(cfg.num_layers):
        x = jllama.block_apply({k: v[i] for k, v in params["blocks"].items()},
                               x, cfg, cos, sin,
                               lambda q, k, v: j_flash(q, k, v, None, True))
    ms = jnp.mean(jnp.square(x), -1, keepdims=True)
    x = x * jax.lax.rsqrt(ms + cfg.rms_norm_eps) * params["lnf_w"]
    z = jnp.einsum("bsh,hv->bsv", x, params["head"])
    z = z - jax.lax.stop_gradient(z.max(-1, keepdims=True))
    nll = jnp.log(jnp.exp(z).sum(-1)) - jnp.take_along_axis(
        z, labels[..., None], -1)[..., 0]
    return nll.sum() / (B * S)


def _leaves(tree):
    return [("wte", tree["wte"]), ("head", tree["head"]),
            ("lnf_w", tree["lnf_w"])] + sorted(tree["blocks"].items())


def test_loss_and_grads_match_jax_block_apply(jax_run):
    jcfg, tcfg = _cfgs()
    p0 = jax_run["state0"]["params"]
    jp = {k: jnp.asarray(v) for k, v in p0.items() if k != "blocks"}
    jp["blocks"] = {k: jnp.asarray(v[0]) for k, v in p0["blocks"].items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(p, jax_run["ids"], jax_run["labels"], jcfg)))(jp)
    step, _ = build_llama_train_step(tcfg, device="cpu")
    state = state_from_numpy(jax_run["state0"], "float32", "cpu")
    loss, grads = step.loss_and_grads(state, jax_run["ids"],
                                      jax_run["labels"])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for (name, g), (_, jg) in zip(_leaves(grads), _leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def _three_steps(run, tcfg):
    state = state_from_numpy(run["state0"], "float32", "cpu")
    assert state["opt"]["t"] == 0
    assert state["opt"]["m"]["blocks"]["q_w"].shape == \
        state["params"]["blocks"]["q_w"].shape
    step, _ = build_llama_train_step(tcfg, device="cpu", learning_rate=LR)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, run["ids"], run["labels"])
        losses.append(float(loss))
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)
    assert losses[-1] < losses[0]
    assert state["opt"]["t"] == STEPS
    ref = params_from_numpy(run["final"], "float32", "cpu")
    for (name, p), (_, r) in zip(_leaves(state["params"]), _leaves(ref)):
        d = (p - r).abs()
        assert float((d <= 1e-6).float().mean()) >= 0.999, name
        assert float(d.max()) <= 2 * LR * STEPS, name


def test_three_steps_match_jax_train_step(jax_run):
    _three_steps(jax_run, _cfgs()[1])


def test_fused_head_loss_and_grads_match_jax_train_step(jax_fused_run):
    """The fused head (the config default): loss and every grad against
    the JAX step's own first gradient, read back from its Adam first
    moment after one step from zero moments (``m = (1 - b1) g``)."""
    run = jax_fused_run
    step, _ = build_llama_train_step(_cfgs(fused_head=True)[1],
                                     device="cpu")
    state = state_from_numpy(run["state0"], "float32", "cpu")
    loss, grads = step.loss_and_grads(state, run["ids"], run["labels"])
    np.testing.assert_allclose(float(loss), run["losses"][0], rtol=1e-5)
    m1 = state_from_numpy(run["state1"], "float32", "cpu")["opt"]["m"]
    for (name, g), (_, m) in zip(_leaves(grads), _leaves(m1)):
        np.testing.assert_allclose(g.numpy(), m.numpy() / (1 - ADAM_B1),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_fused_head_three_steps_match_jax_train_step(jax_fused_run):
    _three_steps(jax_fused_run, _cfgs(fused_head=True)[1])


def test_remat_and_dense_attention_agree():
    """remat only reruns the forward; the dense ``_gqa_attention`` path
    computes the same function as the flash path."""
    _, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    ids = rng.integers(0, tcfg.vocab_size, (B, S))
    labels = np.roll(ids, -1, axis=1)
    out = {}
    for remat, flash in ((True, True), (False, True), (True, False)):
        step, init = build_llama_train_step(tcfg, device="cpu", remat=remat,
                                            use_flash=flash)
        out[remat, flash] = step.loss_and_grads(init(0), ids, labels)
    ref_loss, ref = out[True, True]
    for key, (loss, grads) in out.items():
        tol = 0 if key[1] else 1e-5
        torch.testing.assert_close(loss, ref_loss, rtol=tol, atol=tol)
        for (name, g), (_, r) in zip(_leaves(grads), _leaves(ref)):
            torch.testing.assert_close(g, r, rtol=tol, atol=tol, msg=name)


def test_flash_forward_reruns_under_remat(monkeypatch):
    """Each layer runs the flash forward once, and once more when remat
    recomputes it in the backward; the backward runs once per layer (on
    the card: one ``flash_bwd_dq`` and one ``flash_bwd_dkv`` launch)."""
    from paddle_tpu_torch.ops import flash_attention as tfa
    _, tcfg = _cfgs()
    ids = np.zeros((1, 8), np.int64)
    calls = {"fwd": 0, "bwd": 0}
    for name in calls:
        def counted(*a, _f=getattr(tfa, f"_{name}"), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(tfa, f"_{name}", counted)
    for remat, fwd in ((True, 2), (False, 1)):
        step, init = build_llama_train_step(tcfg, device="cpu", remat=remat)
        calls.update(fwd=0, bwd=0)
        step(init(0), ids, ids)
        assert calls == {"fwd": fwd * tcfg.num_layers,
                         "bwd": tcfg.num_layers}, (remat, calls)


def test_dynamic_rope_tables_at_the_step_length():
    """``dynamic=True`` (the train step's call site) gives the JAX tables
    below and above the original length; serving still refuses."""
    for n in (16, S):
        jc, js = jllama._rope_cos_sin(n, 16, 10000.0, jnp.float32, ROPE)
        tc, ts = tllama._rope_cos_sin(n, 16, 10000.0, torch.float32, ROPE,
                                      dynamic=True)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    with pytest.raises(NotImplementedError, match="dynamic"):
        tllama._rope_cos_sin(S, 16, 10000.0, torch.float32, ROPE)


REFUSED = {"moe": ({"fused_head": False}, {"moe_num_experts": 4}),
           "dp": ({"fused_head": False, "dp": 2}, {}),
           "mp": ({"fused_head": False, "mp": 2}, {}),
           "pp": ({"fused_head": False, "pp": 2}, {}),
           "sep": ({"fused_head": False, "sep": 2}, {}),
           "sharding": ({"fused_head": False, "sharding": 2}, {}),
           "microbatches": ({"fused_head": False, "num_microbatches": 2}, {}),
           "cp-mode": ({"fused_head": False, "cp_mode": "ring"}, {}),
           "sequence-parallel": ({"fused_head": False,
                                  "sequence_parallel": True}, {}),
           "tp-overlap": ({"fused_head": False, "tp_overlap": True}, {}),
           "offload": ({"fused_head": False, "offload_optimizer": True}, {}),
           "stage3": ({"fused_head": False, "sharding_stage": 3}, {}),
           "remat-policy": ({"fused_head": False, "remat_policy": "dots"},
                            {})}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_configurations_raise(name):
    kw, cfg_kw = REFUSED[name]
    cfg = tllama.llama_tiny(**cfg_kw)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        build_llama_train_step(cfg, device="cpu", **kw)
