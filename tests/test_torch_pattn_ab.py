"""CPU checks of what reads the paged-attention kernels' source by text.

``tools/pattn_ab.py`` builds variants of ``kernels/csrc/paged_attention.cu``
and ``norms.cu`` by text edits (ring depths, splits, the rows body for
short chunks).  An edit that no longer applies would build the unedited
kernel under the variant's name, so each is pinned here against the
source, as are the int8-pool cases the tool checks and times and the
int8 bodies' design: codes widened in registers by the exponent-bias
trick, the scales taken out of the sums, no second pass through shared
memory.  No card needed."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import pattn_ab  # noqa: E402

CSRC = ROOT / "paddle_tpu_torch" / "kernels" / "csrc"


@pytest.mark.parametrize("variant", sorted(pattn_ab.TUNINGS))
def test_pattn_ab_edits_apply_to_the_source(variant):
    src = (CSRC / pattn_ab.TUNED_FILE.get(variant, pattn_ab.FILES[0])
           ).read_text()
    assert pattn_ab._edited(src, pattn_ab.TUNINGS[variant]) != src


def test_int8_pool_cases_cover_decode_prefill_and_both_head_dims():
    q8 = [c for c in pattn_ab.PATTN_CASES if c[0].startswith("q8")]
    for kind, Ts in (("decode", 4), ("prefill", 256)):
        for D in (128, 64):
            assert any(kind in c[0] and c[1] == 1 and c[2] == D and c[4] == Ts
                       for c in q8), (kind, D)
    assert {D for _, _, D in pattn_ab.Q8_TIMED} == {128, 64}


def test_int8_bodies_widen_in_registers():
    src = (CSRC / "paged_attention.cu").read_text()
    # the rows body: codes widened exactly, the K scale on the score, p
    # times the V scale one scalar a row
    assert "codes_w<EPC>(kt + i * D + ch * EPC, kf);" in src
    assert "if constexpr (Q8) d *= sk;" in src
    assert "if constexpr (Q8) pv *= sv;" in src
    assert "(float)e[i] * s" not in src and "codes_f<" not in src
    # the prefill body: the products read the codes through ldmatrix, no
    # bf16 tile written from them
    assert "qk_q8<NS, KS, LDC>(s[0], qa, Kc, lane);" in src
    assert "pv_q8<ND, KP, LDC>(acc[0], pa[0], Vc, lane);" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32" in src
    assert "bf16 *T8" not in src
    mma = (CSRC / "mma.cuh").read_text()
    assert "__device__ __forceinline__ void widen_i8(" in mma
    assert "__device__ __forceinline__ void widen_f32(" in mma
