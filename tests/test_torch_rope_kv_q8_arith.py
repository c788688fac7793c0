"""CPU checks of the arithmetic ``rope_kv_write_q8`` (``kernels/csrc/
rope_kv.cu``) quantizes with, emulated exactly in numpy: the scale
RN(m / 127) from RN(1 / 127) and one FMA correction, each code's quotient
RN(x / s) from y = RN(1 / s) and one FMA correction (Markstein's
theorem), rint as one add of 1.5 x 2^23 and the code its low byte, no
clip.  The emulation must equal ``ops.paged_kv.quantize_kv`` (the IEEE
divisions, round half to even, clip) code for code and scale for scale on
``chip_smoke.py``'s hard rows (ties, clips, zero and tiny rows) and on
random rows, and the scale's correction must give RN(m / 127) for every
fp32 mantissa of one binade (a binade's quotients are another's times a
power of two).  The card's own bitwise checks (``chip_smoke.py``,
``tools/rope_softmax_ab.py``) hold the kernel itself to the same plain
version.  No card needed."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_kv as tkv

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

F32, F64 = np.float32, np.float64
RCP127 = F32(1.0) / F32(127.0)          # RN(1 / 127), the kernel's constant


def rn32(s, err):
    """RN to fp32 of the exact value s + err (s a float64 holding it but
    for the tiny ``err``): s rounded, then moved one fp32 step toward err
    where s lay exactly halfway between two fp32 values."""
    r = s.astype(F32)
    lo = np.nextafter(r, F32(-np.inf))
    hi = np.nextafter(r, F32(np.inf))
    r = np.where((s == (r.astype(F64) + lo) / 2) & (err < 0), lo, r)
    return np.where((s == (r.astype(F64) + hi) / 2) & (err > 0), hi, r)


def fma32(a, b, c):
    """RN32(a b + c) exactly, a b exact in float64 (24-bit operands)."""
    p = a.astype(F64) * b.astype(F64)
    s = p + c.astype(F64)
    bb = s - p
    err = (p - (s - bb)) + (c.astype(F64) - bb)
    return rn32(s, err)


def div_rn(a, b, y):
    """rope_kv.cu div_rn: q = RN(a y), then RN(q + RN(a - b q) y)."""
    q = (a.astype(F64) * y.astype(F64)).astype(F32)
    return fma32(fma32(-b, q, a), y, q)


def emulate(x):
    """The kernel's (codes, scale) of head rows x [..., D] (fp32 values)."""
    m = np.maximum(np.abs(x).max(-1), F32(tkv.KV_SCALE_EPS))
    s = div_rn(m, np.full_like(m, 127), np.full_like(m, RCP127))
    y = (1.0 / s.astype(F64)).astype(F32)          # RN(1 / s)
    q = div_rn(x, np.broadcast_to(s[..., None], x.shape),
               np.broadcast_to(y[..., None], x.shape))
    word = (q.astype(F64) + 1.5 * 2 ** 23).astype(F32).view(np.uint32)
    return (word & 0xFF).astype(np.uint8).view(np.int8), s


def test_scale_correction_is_the_rounded_quotient_over_a_binade():
    m = (np.arange(1 << 23, dtype=np.uint32) | np.uint32(0x3F800000)).view(
        F32)
    got = div_rn(m, np.full_like(m, 127), np.full_like(m, RCP127))
    want = rn32(m.astype(F64) / 127, m.astype(F64) - 127 * (
        m.astype(F64) / 127))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("kind", cs.Q8_HARD_KINDS)
def test_codes_equal_quantize_kv_on_hard_rows(kind):
    n = len(cs.Q8_HARD_KINDS)
    x = cs.q8_hard_rows(64 * n, 128, 7)[cs.Q8_HARD_KINDS.index(kind)::n]
    codes, scale = tkv.quantize_kv(torch.from_numpy(x))
    got_c, got_s = emulate(x)
    assert np.array_equal(got_s.view(np.uint32),
                          scale.numpy().view(np.uint32))
    assert np.array_equal(got_c, codes.numpy())


def test_codes_equal_quantize_kv_on_random_rows():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4096, 64))
         * np.exp(rng.uniform(-25, 25, (4096, 1)))).astype(F32)
    codes, scale = tkv.quantize_kv(torch.from_numpy(x))
    got_c, got_s = emulate(x)
    assert np.array_equal(got_s.view(np.uint32),
                          scale.numpy().view(np.uint32))
    assert np.array_equal(got_c, codes.numpy())
