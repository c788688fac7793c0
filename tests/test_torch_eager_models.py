"""The port's eager ``LlamaForCausalLM`` / ``GPTForCausalLM`` with its
``AdamW`` against the JAX package's eager models and optimizer.

``llama_tiny(num_layers=2)`` and a 2-layer GPT (V 128, H 64, 4 heads, P
64), batch 2 x 16.  Each JAX net is built once per session after
``pt.seed(0)`` and run under ``set_flags({"pallas_interpret": True})``
(restored after), so it takes its TPU structure: the Pallas RMSNorm,
SwiGLU, LayerNorm, bias-residual LayerNorm and flash kernels in interpret
mode.  Its ``state_dict()`` goes to the port through
``bridge.state_dict_from_numpy``.  At fp32 1e-5 (relative and absolute):

* eval logits;
* the training loss and every parameter's gradient;
* two ``AdamW(learning_rate=1e-4)`` steps: both losses, and the params
  after them where the first gradient exceeds 1e-7.  Elsewhere the
  gradient is zero or rounding noise (a bias shared by all keys gets
  none), whose sign differs between the two, so each side's params are
  held to 1e-6 relative against the AdamW rule (decay, then the
  bias-corrected update) replayed in numpy on its own gradients.

Also: the state_dict keys are the JAX ones; the bf16 model's logits
(weights cast to bf16, a bf16 config) are within 2e-2 of the JAX bf16
model's; the dense head gives the fused head's
loss and grads; GPT with dropout draws its masks from the model's
generator; configurations outside the slice raise ``NotImplementedError``
naming their ROADMAP item.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core.flags import FLAGS, set_flags
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.bridge import state_dict_from_numpy
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.optimizer import Adam, AdamW

B, S, LR, STEPS = 2, 16, 1e-4, 2
GPT_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
               max_position_embeddings=64)
MODELS = {
    "llama": (lambda **kw: jllama.LlamaForCausalLM(jllama.llama_tiny(
        num_layers=2, **kw)), tllama.LlamaForCausalLM,
        lambda **kw: tllama.llama_tiny(num_layers=2, **kw)),
    "gpt": (lambda **kw: jgpt.GPTForCausalLM(jgpt.GPTConfig(**GPT_CFG,
                                                            **kw)),
            tgpt.GPTForCausalLM,
            lambda **kw: tgpt.GPTConfig(**GPT_CFG, **kw)),
}
FP32 = dict(rtol=1e-5, atol=1e-5)


def _np(v):
    return np.array(np.asarray(v), dtype=np.float32, copy=True)


def _jax_run(name):
    """The JAX eager model's initial state_dict, ids and labels, eval
    logits (fp32, and of the same weights cast to bf16 under a bf16
    config), first loss and gradients, losses over STEPS AdamW steps and
    the final state_dict (numpy)."""
    build = MODELS[name][0]
    pt.seed(0)
    net = build()
    sd0 = {k: _np(v) for k, v in net.state_dict().items()}
    V = sd0["lm_head.weight"].shape[1] if "lm_head.weight" in sd0 else \
        sd0["gpt.wte.weight"].shape[0]
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (B, S))
    labels = np.roll(ids, -1, axis=1)
    old = FLAGS.pallas_interpret
    set_flags({"pallas_interpret": True})
    try:
        net.eval()
        logits = _np(net(pt.to_tensor(ids)).numpy())
        net.train()
        pt.seed(0)
        net16 = build(dtype="bfloat16").to(dtype="bfloat16")
        net16.eval()
        logits16 = _np(net16(pt.to_tensor(ids)).astype("float32").numpy())
        opt = pt.optimizer.AdamW(learning_rate=LR,
                                 parameters=net.parameters())
        losses, grads_steps = [], []
        for _ in range(STEPS):
            loss = net(pt.to_tensor(ids), pt.to_tensor(labels))
            loss.backward()
            grads_steps.append({k: _np(p.grad.numpy())
                                for k, p in net.named_parameters()})
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        final = {k: _np(v) for k, v in net.state_dict().items()}
    finally:
        set_flags({"pallas_interpret": old})
    return dict(sd0=sd0, ids=ids, labels=labels, logits=logits,
                logits16=logits16, grads=grads_steps[0],
                grads_steps=grads_steps, losses=losses, final=final)


def _adamw_rule(p0, grads, lr=LR, coeff=0.01, b1=0.9, b2=0.999, eps=1e-8):
    """fp32 numpy replay of ``AdamW`` (``optimizers.py:47-139``): decay
    ``p *= 1 - lr * coeff``, then the bias-corrected Adam update."""
    f = np.float32
    p, m, v = p0.astype(f), np.zeros_like(p0, f), np.zeros_like(p0, f)
    for t, g in enumerate(grads, 1):
        p = p * f(1 - lr * coeff)
        m = f(b1) * m + f(1 - b1) * g
        v = f(b2) * v + f(1 - b2) * np.square(g)
        mhat, vhat = m / f(1 - b1 ** t), v / f(1 - b2 ** t)
        p = p - f(lr) * (mhat / (np.sqrt(vhat) + f(eps)))
    return p


def _port(name, run, cast=None, **cfg):
    net = MODELS[name][1](MODELS[name][2](**cfg), device="cpu")
    net.load_state_dict(state_dict_from_numpy(run["sd0"], device="cpu"))
    return net if cast is None else net.to(cast)


def _ids(run):
    return torch.from_numpy(run["ids"]), torch.from_numpy(run["labels"])


def _loss_and_grads(net, run):
    ids, labels = _ids(run)
    loss = net(ids, labels)
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy().copy()
                                  for k, p in net.named_parameters()}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """``(name, JAX run)``, one JAX run per model per session."""
    return request.param, _jax_run(request.param)


def test_state_dict_keys_are_the_jax_ones(model):
    name, run = model
    net = _port(name, run)
    assert list(net.state_dict()) == list(run["sd0"])
    for k, v in net.state_dict().items():
        assert tuple(v.shape) == run["sd0"][k].shape, k


def test_eval_logits_match_jax(model):
    name, run = model
    net = _port(name, run).eval()
    with torch.no_grad():
        logits = net(_ids(run)[0])
    np.testing.assert_allclose(logits.numpy(), run["logits"], **FP32)


def test_loss_and_every_grad_match_jax(model):
    name, run = model
    loss, grads = _loss_and_grads(_port(name, run), run)
    np.testing.assert_allclose(loss, run["losses"][0], **FP32)
    assert sorted(grads) == sorted(run["grads"])
    for k, g in grads.items():
        np.testing.assert_allclose(g, run["grads"][k], err_msg=k, **FP32)


def test_two_adamw_steps_match_jax(model):
    name, run = model
    net = _port(name, run)
    opt = AdamW(learning_rate=LR, parameters=net.named_parameters())
    ids, labels = _ids(run)
    losses, grads_steps = [], []
    for _ in range(STEPS):
        loss = net(ids, labels)
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


def test_bf16_logits_match_jax(model):
    name, run = model
    net = _port(name, run, torch.bfloat16, dtype="bfloat16").eval()
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    with torch.no_grad():
        logits = net(_ids(run)[0])
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(), run["logits16"],
                               rtol=2e-2, atol=2e-2)


def test_dense_head_gives_the_fused_heads_loss_and_grads(model):
    name, run = model
    loss, grads = _loss_and_grads(_port(name, run, fused_head=False), run)
    np.testing.assert_allclose(loss, run["losses"][0], **FP32)
    for k, g in grads.items():
        np.testing.assert_allclose(g, run["grads"][k], err_msg=k, **FP32)


def test_gpt_dropout_masks_come_from_the_generator():
    cfg = tgpt.GPTConfig(**GPT_CFG, dropout=0.1)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (B, S)))
    nets = [tgpt.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        s), device="cpu") for s in (3, 3, 4)]
    for n in nets[1:]:
        n.load_state_dict(nets[0].state_dict())
    a, b, c = (n(ids, ids) for n in nets)
    assert torch.isfinite(a) and torch.equal(a, b) and not torch.equal(a, c)
    a.backward()
    assert all(torch.isfinite(p.grad).all() for p in nets[0].parameters())
    nets[0].eval()
    ref = tgpt.GPTForCausalLM(tgpt.GPTConfig(**GPT_CFG), device="cpu").eval()
    ref.load_state_dict(nets[0].state_dict())
    with torch.no_grad():
        torch.testing.assert_close(nets[0](ids), ref(ids))


def test_adam_l2_decay_and_amsgrad_run():
    """Adam's L2 ``weight_decay`` enters the gradient, AdamW's decoupled
    decay follows ``apply_decay_param_fun`` by name, and ``amsgrad`` keeps
    the running max of the second moment."""
    w = torch.nn.Parameter(torch.ones(3))
    opt = Adam(learning_rate=0.1, parameters=[w], weight_decay=0.5,
               amsgrad=True)
    w.grad = torch.zeros(3)
    opt.step()
    assert torch.all(w < 1)            # the decay term alone moved it
    assert set(opt.state[w]) == {"moment1", "moment2", "moment2_max"}
    a, b = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(2))
    opt = AdamW(learning_rate=0.1, weight_decay=0.5,
                parameters=[("a", a), ("b", b)],
                apply_decay_param_fun=lambda n: n == "a")
    a.grad, b.grad = torch.zeros(2), torch.zeros(2)
    opt.step()
    torch.testing.assert_close(a.detach(), torch.full((2,), 0.95))
    torch.testing.assert_close(b.detach(), torch.ones(2))
    opt.clear_grad()
    assert a.grad is None and b.grad is None


def test_adamw_decay_filter_sees_other_names_than_jax():
    """A documented divergence (ROADMAP queue 3): Paddle's usual filter
    ``lambda n: "norm" not in n and "bias" not in n`` sees the JAX eager
    step's ``p.name``, a ``tensor_<n>`` counter, and so decays every
    parameter there; the port passes the ``named_parameters()`` paths and
    skips the norm and the biases.  Zero gradients: only the decay
    ``p *= 1 - lr * coeff`` moves a parameter."""
    from paddle_tpu_torch.nn.layer import LayerNorm, Linear

    def keep(n):
        return "norm" not in n and "bias" not in n

    class JNet(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.linear, self.norm = pt.nn.Linear(4, 4), pt.nn.LayerNorm(4)

    class TNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.linear = Linear(4, 4, device="cpu")
            self.norm = LayerNorm(4, device="cpu")

    jnet, tnet = JNet(), TNet()
    for p in jnet.parameters():
        p.set_value(np.ones(p.shape, np.float32))
        p.grad = pt.to_tensor(np.zeros(p.shape, np.float32))
    with torch.no_grad():
        for p in tnet.parameters():
            p.fill_(1.0)
            p.grad = torch.zeros_like(p)
    assert all(n.startswith("tensor_") for n in
               (p.name for p in jnet.parameters()))
    pt.optimizer.AdamW(learning_rate=0.1, weight_decay=0.5,
                       parameters=jnet.parameters(),
                       apply_decay_param_fun=keep).step()
    AdamW(learning_rate=0.1, weight_decay=0.5,
          parameters=tnet.named_parameters(),
          apply_decay_param_fun=keep).step()
    jax_after = {k: float(np.asarray(v).reshape(-1)[0])
                 for k, v in jnet.state_dict().items()}
    port_after = {k: float(v.reshape(-1)[0])
                  for k, v in tnet.state_dict().items()}
    assert set(jax_after) == set(port_after)
    assert jax_after == pytest.approx({k: 0.95 for k in jax_after})
    assert port_after == pytest.approx({k: 0.95 if k == "linear.weight"
                                        else 1.0 for k in port_after})


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("field,item", [("use_mp", "item 17"),
                                        ("moe_num_experts", "item 15")])
def test_unported_configs_raise(name, field, item):
    cfg = MODELS[name][2](**{field: True if field == "use_mp" else 4})
    with pytest.raises(NotImplementedError, match=item):
        MODELS[name][1](cfg, device="cpu")


@pytest.mark.parametrize("kw", [dict(grad_clip=object()),
                                dict(learning_rate=lambda: 1e-3),
                                dict(multi_precision=True)],
                         ids=["grad_clip", "scheduler", "multi_precision"])
def test_unported_optimizer_options_raise(kw):
    with pytest.raises(NotImplementedError, match="item 17"):
        AdamW(parameters=[torch.nn.Parameter(torch.ones(1))], **kw)


def test_eager_models_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a CUDA device")
    for name in sorted(MODELS):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MODELS[name][1](MODELS[name][2]())
