"""The port's flash attention against the JAX package's.

The plain PyTorch forward (out and lse) and its autograd backward (dq, dk,
dv) must match the forward and backward rules of the JAX
``flash_attention`` custom VJP, which run the Pallas kernels in interpret
mode on the CPU, on the same numpy-seeded inputs: causal MHA and GQA
(G = 2), S = 40 (padded to a block inside the TPU kernel) and S = 64,
Sq != Sk, segment ids with no empty row and the three bias shapes.
Tolerance fp32 1e-5, bf16 2e-2.  Also: ``flash_attention_with_lse``
differentiates through its lse, a CUDA request without CUDA raises, and
the backends that ship inside JAX are refused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import (_flash_bwd_rule,
                                                   _flash_fwd_rule)
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops.flash_backends import run_backend, tuned_flash

TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
D = 16
# (B, Sq, Sk, Hq, Hkv, causal, segments, bias shape or None)
CASES = {"mha-causal-s40": (1, 40, 40, 2, 2, True, False, None),
         "gqa-causal-s64": (2, 64, 64, 4, 2, True, False, None),
         "sq-ne-sk": (1, 40, 24, 2, 1, True, False, None),
         "segments": (2, 40, 40, 2, 1, True, True, None),
         "bias-1-hq": (2, 40, 40, 2, 1, False, False, (1, 2)),
         "bias-b-1": (2, 40, 40, 2, 1, False, False, (2, 1)),
         "bias-b-hq": (2, 40, 40, 2, 1, True, False, (2, 2))}
PARAMS = [pytest.param(name, "fp32", id=f"{name}-fp32") for name in CASES] \
    + [pytest.param(name, "bf16", id=f"{name}-bf16")
       for name in ("gqa-causal-s64",)]


def _inputs(name, seed=0):
    B, Sq, Sk, Hq, Hkv, causal, seg, bias = CASES[name]
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    c = dict(q=f(B, Sq, Hq, D), k=f(B, Sk, Hkv, D), v=f(B, Sk, Hkv, D),
             g=f(B, Sq, Hq, D), causal=causal, seg=None, bias=None)
    if seg:                 # sorted runs under causal: every row sees itself
        s = np.sort(rng.integers(0, 3, (B, Sq)), axis=1).astype(np.int32)
        c["seg"] = s
    if bias is not None:
        c["bias"] = f(*bias, Sq, Sk)
    return c


def _jax(c, dt):
    j = lambda a: None if a is None else jnp.asarray(a, JDT[dt])  # noqa: E731
    seg = None if c["seg"] is None else jnp.asarray(c["seg"])

    @jax.jit
    def run(q, k, v, g, bias):
        # the custom VJP's own rules: one forward kernel (out and lse as
        # residual), then the dq and dk/dv kernels
        out, res = _flash_fwd_rule(q, k, v, None, c["causal"], seg, None,
                                   bias)
        return (out, res[4]) + _flash_bwd_rule(None, c["causal"], res,
                                               g)[:3]
    res = run(j(c["q"]), j(c["k"]), j(c["v"]), j(c["g"]), j(c["bias"]))
    return [np.asarray(r, np.float32) for r in res]


def _torch(c, dt):
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        a.copy()).to(TDT[dt])
    seg = None if c["seg"] is None else torch.from_numpy(c["seg"].copy())
    q, k, v = (t(c[n]).requires_grad_(True) for n in ("q", "k", "v"))
    out, lse = tfa.flash_attention_with_lse(q, k, v, None, c["causal"], seg,
                                            None, t(c["bias"]))
    tfa.flash_attention(q, k, v, None, c["causal"], seg, None,
                        t(c["bias"])).backward(t(c["g"]))
    return [x.detach().float().numpy()
            for x in (out, lse, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("name,dt", PARAMS)
def test_flash_fwd_bwd_match_jax_interpret_kernels(name, dt):
    c = _inputs(name)
    for what, got, ref in zip(("out", "lse", "dq", "dk", "dv"),
                              _torch(c, dt), _jax(c, dt)):
        assert got.shape == ref.shape, what
        np.testing.assert_allclose(got, ref, err_msg=what, **TOL[dt])


def test_with_lse_differentiates_through_lse():
    """d/d(q, k, v) of sum(out * g) + sum(lse * w) against autograd of the
    same function written densely in fp32."""
    c = _inputs("gqa-causal-s64", seed=3)
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((2, 4, 64, 1)).astype(
        np.float32))
    q, k, v = (torch.from_numpy(c[n]).requires_grad_(True)
               for n in ("q", "k", "v"))
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    got = torch.autograd.grad((out * torch.from_numpy(c["g"])).sum()
                              + (lse * w).sum(), (q, k, v))
    kk, vv = (x.repeat_interleave(2, dim=2).transpose(1, 2) for x in (k, v))
    s = (q.transpose(1, 2) @ kk.transpose(-1, -2)) / D ** 0.5
    s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(), -1e30)
    ref_out = (torch.softmax(s, -1) @ vv).transpose(1, 2)
    ref = torch.autograd.grad((ref_out * torch.from_numpy(c["g"])).sum()
                              + (torch.logsumexp(s, -1, keepdim=True)
                                 * w).sum(), (q, k, v))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


def test_standalone_bwd_matches_autograd():
    c = _inputs("gqa-causal-s64", seed=5)
    q, k, v, g = (torch.from_numpy(c[n]) for n in ("q", "k", "v", "g"))
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    tfa.flash_attention(qq, kk, vv, causal=True).backward(g)
    for a, b in zip(got, (qq.grad, kk.grad, vv.grad)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_backends_and_cuda_requests():
    c = _inputs("mha-causal-s40")
    q, k, v = (torch.from_numpy(c[n]) for n in ("q", "k", "v"))
    ref = tfa.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(tuned_flash(q, k, v, causal=True), ref,
                               rtol=0, atol=0)
    torch.testing.assert_close(run_backend("ours", q, k, v, D ** -0.5, True),
                               ref, rtol=0, atol=0)
    for name in ("splash", "jax_flash"):
        with pytest.raises(NotImplementedError, match="ships inside JAX"):
            run_backend(name, q, k, v, D ** -0.5, True)
    with pytest.raises(ValueError, match="GQA"):
        tfa.flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1).clone(),
                            v[:, :, :1].expand(-1, -1, 3, -1).clone())
    from paddle_tpu_torch.ops.cuda import flash_attention as fc
    with pytest.raises(ValueError, match="CUDA tensors"):
        fc.flash_fwd_cuda(q, k, v, D ** -0.5, True)
    if not torch.cuda.is_available():
        from paddle_tpu_torch.models.llama import llama_tiny
        from paddle_tpu_torch.parallel.train_step import \
            build_llama_train_step
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_llama_train_step(llama_tiny(fused_head=False))
