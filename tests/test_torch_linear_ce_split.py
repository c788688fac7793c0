"""The linear-CE head's split route (fp32 x with a bf16 head) on the CPU.

On the card the GPT head's forward and dz split fp32 x into bf16 halves,
``x_hi = bf16(x)`` and ``x_lo = bf16(x - x_hi)``, and sum the two bf16
products in one fp32 accumulator (``kernels/csrc/linear_ce.cu``:
``linear_ce_split_x``, then ``linear_ce_fwd_split`` / ``linear_ce_dz_split``).
Those kernels run only there; here:

* the split's plain version (``lce_split_x_ref``): ``x_hi`` is x rounded
  to bf16, ``x - x_hi`` is exact, and ``|x - x_hi - x_lo| <= 2^-17 |x|``,
  a bound the data reaches (``2^-18`` is not one);
* a torch emulation of the two products (``[x_hi | x_lo] @ [w | w]^T``,
  fp32 sums of exact bf16 x bf16 products) at T 256, H 768, V 4096: its
  nll within 1e-4 of the JAX Pallas forward (``pallas_call`` at
  ``paddle_tpu/ops/pallas/linear_ce.py:152``, interpret mode) on fp32 x
  and bf16 w, and the same emulation with ``x_hi`` alone (what x rounded
  to bf16 gives) not;
* ``chip_smoke.py``'s split checks on those emulations: nll, lse and dz
  of the two products pass, those of ``x_hi`` alone fail; and the smoke
  counts the split as two bf16 products (three for dw) and two pre-pass
  launches a GPT step;
* dw (``linear_ce_dw_split``: ``dz_hi^T x_hi + dz_hi^T x_lo + dz_lo^T
  x_hi`` on the halves of dz and x): dz's plain halves
  (``lce_split_dz_ref``) hold dz to ``2^-17``; the three products'
  plain version (``lce_dw_split_ref``) equals the JAX Pallas dw
  (``pallas_call`` at ``paddle_tpu/ops/pallas/linear_ce.py:270``,
  interpret mode) except where the fp32 dw lies within the smoke's
  allowance of a bf16 rounding midpoint, and the one-product and
  two-product versions do not; the smoke's dw check passes the three
  products and raises on the others.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.fused_cross_entropy import \
    linear_cross_entropy as j_lce
from paddle_tpu_torch.ops import fused_cross_entropy as tfce

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

T, H, V, CHUNK = 256, 768, 4096, 2048


def _x(shape, seed, spread=0):
    """fp32 normals, each scaled by 2^k for k uniform in [-spread, spread]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp2(
        rng.integers(-spread, spread + 1, shape))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("spread", [0, 40])
def test_split_plain_version_holds_x_to_2_pow_minus_17(spread):
    x = _x((512, 768), 3, spread)
    xs = tfce.lce_split_x_ref(x)
    assert xs.dtype == torch.bfloat16 and xs.shape == (2, 512, 768)
    assert torch.equal(xs[0], x.bfloat16())
    r = x - xs[0].float()                       # exact in fp32
    assert torch.equal(r.double(), x.double() - xs[0].double())
    assert torch.equal(xs[1], r.bfloat16())
    err = (x.double() - xs[0].double() - xs[1].double()).abs()
    rel = err / x.double().abs()
    assert float(rel.max()) <= 2.0 ** -17
    assert float(rel.max()) > 2.0 ** -18        # the tighter bound fails


def _case(seed=0):
    """The GPT head's statistics at a small T: x ~ N(0, 1) fp32, w ~
    N(0, 0.02) bf16, random labels, an N(0, 1) cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, H)).astype(np.float32)
    w = (rng.standard_normal((V, H)) * 0.02).astype(np.float32)
    lab = rng.integers(0, V, T).astype(np.int32)
    g = rng.standard_normal(T).astype(np.float32)
    return x, w, lab, g


def _emulated(xt, wt, terms):
    """x and w as the split route's products see them: ``[x_hi | x_lo]``
    (``terms`` 2) or ``x_hi`` (1) by ``[w | w]``, fp32 operands holding
    bf16 values, so ``x @ w.T`` over them is fp32 sums of exact bf16
    products in one accumulator."""
    xs = tfce.lce_split_x_ref(xt)[:terms]
    return (torch.cat(tuple(xs), 1).float(),
            torch.cat((wt,) * terms, 1).float())


@pytest.fixture
def pallas_interpret():
    from paddle_tpu.core.flags import FLAGS, set_flags
    old = FLAGS.pallas_interpret
    set_flags({"pallas_interpret": True})
    yield
    set_flags({"pallas_interpret": old})


def test_two_products_match_the_pallas_forward_one_does_not(
        pallas_interpret):
    x, w, lab, _ = _case()
    ref = np.asarray(j_lce(jnp.asarray(x), jnp.asarray(w, jnp.bfloat16),
                           jnp.asarray(lab), backend="pallas", chunk=CHUNK))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w).bfloat16()
    labt = torch.from_numpy(lab).long()
    err = {}
    for terms in (2, 1):
        nll, _ = tfce.lce_fwd_ref(*_emulated(xt, wt, terms), labt,
                                  chunk=CHUNK)
        err[terms] = float(np.abs(nll.numpy() - ref).max())
    assert err[2] <= 1e-4, err
    assert err[1] > 1e-4, err


def test_smoke_split_checks_tell_two_products_from_one():
    """``chip_smoke.check_split`` on the emulations: the two products as
    the kernels' (nll, lse, dz) pass, x_hi alone raises."""
    x, w, lab, g = _case(1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w).bfloat16()
    labt, gt = torch.from_numpy(lab).long(), torch.from_numpy(g)
    case = ("split", T, H, V, CHUNK, "float32", "bfloat16", None, 0.0)
    c0 = (V - 1) // CHUNK * CHUNK
    nll_p, lse_p = tfce.lce_fwd_ref(xt, wt, labt, chunk=CHUNK)
    dz_p = tfce.lce_dz_ref(xt, wt[c0:], labt, lse_p, gt, c0, V)
    got = {}
    for terms in (2, 1):
        xe, we = _emulated(xt, wt, terms)
        nll, lse = tfce.lce_fwd_ref(xe, we, labt, chunk=CHUNK)
        got[terms] = (nll, lse, tfce.lce_dz_ref(xe, we[c0:], labt, lse_p,
                                                gt, c0, V))
    n, l, d = cs.check_split("two products", case, xt, wt, labt, lse_p, gt,
                             c0, got[2], (nll_p, lse_p, dz_p))
    assert n <= cs.LCE_ABS and l <= cs.LCE_ABS and d <= 1.0
    with pytest.raises(cs.SmokeFailure, match="split route misses"):
        cs.check_split("x_hi alone", case, xt, wt, labt, lse_p, gt, c0,
                       got[1], (nll_p, lse_p, dz_p))


def test_smoke_counts_the_split_as_two_bf16_products():
    Tg, Hg, Vg, C = 8192, 768, 32768, 2048
    split = cs.lce_bytes_ops(Tg, Hg, Vg, C, 4, 2)
    for name in ("linear_ce_fwd", "linear_ce_dz"):
        assert split[name][1:] == (4 * Tg * Hg * Vg, "bfloat16")
    assert split["linear_ce_dw"][1:] == (6 * Tg * Hg * Vg, "bfloat16")
    # dz written as two bf16 halves beside the fwd's reads
    assert split["linear_ce_dz"][0] - split["linear_ce_fwd"][0] == \
        Tg * Vg * (2 + 2)
    assert split["linear_ce_split_x"][0] == 8 * Tg * Hg
    f32 = cs.lce_bytes_ops(Tg, Hg, Vg, C, 4, 4)
    assert f32["linear_ce_fwd"][1:] == (2 * Tg * Hg * Vg, "float32")
    bf16 = cs.lce_bytes_ops(Tg, Hg, Vg, C, 2, 2)
    assert bf16["linear_ce_dz"][1:] == (2 * Tg * Hg * Vg, "bfloat16")
    # one pre-pass a forward call and one a backward call, on fp32 x only
    assert cs.GPT_PER_STEP["linear_ce_split_x"] == 2
    for bf16_x in (cs.LCE_PER_STEP, cs.EAGER_GPT_PER_STEP,
                   cs.EAGER_LLAMA_PER_STEP):
        assert "linear_ce_split_x" not in bf16_x


@pytest.mark.parametrize("spread", [0, 40])
def test_split_dz_plain_version_holds_dz_to_2_pow_minus_17(spread):
    dz = _x((512, 2048), 4, spread) * 1e-3
    dzs = tfce.lce_split_dz_ref(dz)
    assert dzs.dtype == torch.bfloat16 and dzs.shape == (2, 512, 2048)
    assert torch.equal(dzs[0], dz.bfloat16())
    assert torch.equal(dzs[1], (dz - dzs[0].float()).bfloat16())
    err = (dz.double() - dzs[0].double() - dzs[1].double()).abs()
    assert float((err / dz.double().abs()).max()) <= 2.0 ** -17


def _dw_terms(dz, xt):
    """The split dw's three bf16 products on the halves of dz and x, each
    fp32 ``[width, H]``: (dz_hi x_hi, dz_hi x_lo, dz_lo x_hi)."""
    dzs, xs = tfce.lce_split_dz_ref(dz), tfce.lce_split_x_ref(xt)
    hi, lo = dzs[0].float().t(), dzs[1].float().t()
    return hi @ xs[0].float(), hi @ xs[1].float(), lo @ xs[0].float()


def _dw_case(seed):
    """The GPT head's statistics (``_case``) with the torch plain
    version's lse, fp32 dz of each slab and fp32 dw before its rounding."""
    x, w, lab, g = _case(seed)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w).bfloat16()
    labt, gt = torch.from_numpy(lab).long(), torch.from_numpy(g)
    _, lse = tfce.lce_fwd_ref(xt, wt, labt, chunk=CHUNK)
    _, dw_t = tfce.lce_bwd_ref(xt, wt.float(), labt, lse, gt, chunk=CHUNK)
    dzs = [tfce.lce_dz_ref(xt, wt[c0:c0 + CHUNK], labt, lse, gt, c0, V)
           for c0 in range(0, V, CHUNK)]
    return xt, wt, labt, gt, lse, dzs, dw_t


def _versions(xt, dzs):
    """dw (bf16) of the three products and of fewer: ``{name: [V, H]}``."""
    out = {}
    for dz in dzs:
        t1, t2, t3 = _dw_terms(dz, xt)
        for name, v in (("three", t1 + t2 + t3), ("one", t1),
                        ("without lo x_hi", t1 + t2),
                        ("without hi x_lo", t1 + t3)):
            out.setdefault(name, []).append(v.bfloat16())
    return {k: torch.cat(v) for k, v in out.items()}


def test_three_products_match_the_pallas_dw_fewer_do_not(pallas_interpret):
    import jax

    x, w, lab, g = _case(2)
    xj, wj, labj = (jnp.asarray(x), jnp.asarray(w, jnp.bfloat16),
                    jnp.asarray(lab))
    gj = jnp.asarray(g)
    dw_j = jax.grad(lambda ww: (j_lce(xj, ww, labj, backend="pallas",
                                      chunk=CHUNK) * gj).sum())(wj)
    dw_j = torch.from_numpy(np.asarray(dw_j.astype(jnp.float32)))
    xt, wt, labt, gt, lse, dzs, dw_t = _dw_case(2)
    # the three products as the kernel forms them, and lce_dw_split_ref
    vers = _versions(xt, dzs)
    ref = torch.cat([tfce.lce_dw_split_ref(tfce.lce_split_dz_ref(dz),
                                           tfce.lce_split_x_ref(xt))
                     for dz in dzs])
    assert ref.dtype == torch.bfloat16 and ref.shape == (V, H)
    # near a tie: the fp32 dw within the smoke's allowance of a bf16
    # rounding midpoint, where a rounding may go either way
    allow = torch.cat([cs.split_dw_allowance(
        xt, wt[c0:c0 + CHUNK].float(), lse, gt, dz)
        for c0, dz in zip(range(0, V, CHUNK), dzs)])
    to_mid = cs.half_ulp_bf16(dw_t) - (dw_t - dw_t.bfloat16().float()).abs()
    near = to_mid <= allow
    # the allowance is wide where dw is a sum of many small terms (no
    # label in the column); a label's column is dominated by one product
    label_cols = torch.zeros(V, dtype=torch.bool)
    label_cols[labt] = True
    assert float(near[label_cols].float().mean()) < 0.2
    assert int((~near).sum()) > 0.3 * near.numel()
    for name, v in (("three", vers["three"]), ("lce_dw_split_ref", ref)):
        off = (v.float() != dw_j) & ~near
        assert not bool(off.any()), (name, int(off.sum()))
    for name in ("one", "without lo x_hi", "without hi x_lo"):
        off = (vers[name].float() != dw_j) & ~near
        assert int(off.sum()) > 0, name


def test_smoke_dw_check_passes_three_products_raises_on_fewer():
    """``chip_smoke``'s split dw check with each emulation as the kernels'
    dw: the three products pass, the one product and each pair raise.
    The distances of the four come from one ``split_dw_excess`` pass (the
    plain versions' products are made once), each judged as the kernels'
    by ``judge_split_dw``, as ``check_split_dw`` judges one."""
    xt, wt, labt, gt, lse, dzs, dw_t = _dw_case(3)
    vers = _versions(xt, dzs)
    case = ("split", T, H, V, CHUNK, "float32", "bfloat16", None, 0.0)
    worst = cs.split_dw_excess(case, xt, wt, labt, lse, gt, vers, dw_t)

    def as_kernels(name):
        return {"kernels": worst[name], **{k: v for k, v in worst.items()
                                           if k not in vers}}
    d = cs.judge_split_dw("three products", T, as_kernels("three"))
    assert d <= 1.0
    for name in ("one", "without lo x_hi", "without hi x_lo"):
        with pytest.raises(cs.SmokeFailure, match="misses its bound"):
            cs.judge_split_dw(name, T, as_kernels(name))
