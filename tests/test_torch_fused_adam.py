"""The port's ``incubate.nn.functional.fused_adam`` against the JAX
package's.

Three tensors (one bf16 with an fp32 master copy where ``master_weights``
is on) take three steps of Adam and of AdamW from the same numpy-seeded
params, grads and moments; ``beta*_pows`` hold βᵗ and come back advanced;
``lrs`` and the pows are a scalar or a list; ``skip_update`` passes one
tensor through.  Every returned tensor equals JAX's to fp32 1e-5 (bf16
params 2e-2 relative and absolute).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.nn import functional as jIF
from paddle_tpu_torch.incubate.nn import functional as tIF

SHAPES = [(4, 8), (16,), (3, 2, 5)]
TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(v):
    v = v.numpy() if hasattr(v, "numpy") else v
    return np.array(np.asarray(v), dtype=np.float32, copy=True)


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


CASES = {
    "adam scalar lr and pows": dict(),
    "adamw list lr and pows": dict(adamw=True, lists=True),
    "adamw master weights": dict(adamw=True, master=True),
    "adam skip_update": dict(skip=True, lists=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_adam_three_steps_match_jax(case):
    c = CASES[case]
    params, m1, m2 = _arrays(0), _arrays(1), [np.abs(a) for a in _arrays(2)]
    master = c.get("master", False)
    pdt = ["bfloat16" if master and i == 0 else "float32"
           for i in range(len(SHAPES))]
    lrs = [1e-2, 2e-3, 5e-3] if c.get("lists") else 1e-2
    pows1 = [0.9, 0.81, 0.729] if c.get("lists") else 0.9
    pows2 = [0.999, 0.998, 0.997] if c.get("lists") else 0.999
    skip = [False, True, False] if c.get("skip") else None
    kw = dict(use_adamw=c.get("adamw", False), weight_decay=0.05)

    def lst(v, conv):
        return [conv(a) for a in v] if isinstance(v, list) else v

    def to_t(a, dt="float32"):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(torch.bfloat16) if dt == "bfloat16" else t

    def to_j(a, dt="float32"):
        t = pt.to_tensor(np.array(a, copy=True))
        return t.astype(dt) if dt != "float32" else t
    t_state = ([to_t(p, d) for p, d in zip(params, pdt)],
               [to_t(a) for a in m1], [to_t(a) for a in m2],
               lst(pows1, lambda v: torch.tensor(v)),
               lst(pows2, lambda v: torch.tensor(v)),
               [to_t(p) for p in params] if master else None)
    j_state = ([to_j(p, d) for p, d in zip(params, pdt)],
               [to_j(a) for a in m1], [to_j(a) for a in m2],
               lst(pows1, lambda v: to_j(np.float32(v))),
               lst(pows2, lambda v: to_j(np.float32(v))),
               [to_j(p) for p in params] if master else None)
    for step in range(3):
        grads = _arrays(10 + step)
        tp, tm1, tm2, tb1, tb2, tmw = tIF.fused_adam(
            t_state[0], [to_t(g) for g in grads], lrs, t_state[1],
            t_state[2], t_state[3], t_state[4], master_weights=t_state[5],
            skip_update=skip, **kw)
        jp, jm1, jm2, jb1, jb2, jmw = jIF.fused_adam(
            j_state[0], [to_j(g) for g in grads], lrs, j_state[1],
            j_state[2], j_state[3], j_state[4], master_weights=j_state[5],
            skip_update=skip, **kw)
        for i in range(len(SHAPES)):
            assert tp[i].dtype == t_state[0][i].dtype
            np.testing.assert_allclose(
                _np(tp[i].float()), _np(jp[i].astype("float32")),
                **(BF16 if pdt[i] == "bfloat16" else TOL))
            for got, want in ((tm1, jm1), (tm2, jm2), (tb1, jb1),
                              (tb2, jb2)):
                np.testing.assert_allclose(_np(got[i]), _np(want[i]), **TOL)
            if master:
                np.testing.assert_allclose(_np(tmw[i]), _np(jmw[i]), **TOL)
            else:
                assert tmw[i] is None and jmw[i] is None
            if skip and skip[i]:
                assert tp[i] is t_state[0][i] and tm1[i] is t_state[1][i]
        # the pows come back advanced by one factor
        np.testing.assert_allclose(
            _np(tb1[0]), _np(t_state[3][0] if isinstance(t_state[3], list)
                             else t_state[3]) * 0.9, rtol=1e-6)
        t_state = (tp, tm1, tm2, tb1 if c.get("lists") else tb1[0],
                   tb2 if c.get("lists") else tb2[0], tmw)
        j_state = (jp, jm1, jm2, jb1 if c.get("lists") else jb1[0],
                   jb2 if c.get("lists") else jb2[0], jmw)
