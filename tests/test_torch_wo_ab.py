"""CPU checks of what reads the weight-only kernels' source by text.

``tools/wo_ab.py`` builds variants of ``kernels/csrc/quant_linear.cu`` by
text edits (cut-down main loops, fixed launch choices).  An edit that no
longer applies would build and time the unedited kernel under the
variant's name, so each is pinned here against the source, as are the
kernel names the profiler reports and the launch counters read.  No card
needed."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import wo_ab  # noqa: E402

CSRC = ROOT / "paddle_tpu_torch" / "kernels" / "csrc"
QL_CU = CSRC / "quant_linear.cu"


@pytest.mark.parametrize("variant", sorted({**wo_ab.TUNINGS,
                                            **wo_ab.ABLATIONS}))
def test_wo_ab_edits_apply_to_the_source(variant):
    cuts = {**wo_ab.TUNINGS, **wo_ab.ABLATIONS}[variant]
    src = QL_CU.read_text()
    edited = wo_ab._ablated(src, cuts)
    assert edited != src


def test_decode_body_is_the_wgmma_one_and_the_old_body_is_gone():
    src = QL_CU.read_text()
    assert "    wo_dec(const WoArgs a" in src
    for old in ("wo_mma", "SmallM", "launch_mma", "cooperative_groups",
                "mma_bf16("):
        assert old not in src, old
    # both widths count their decode launches under the unchanged names
    for width in ("INT8", "INT4"):
        assert (f"count_launch(CNT_WO_{width}_SMALL_M, launch_decode(a, s))"
                in src), width


def test_split_fold_is_shared_not_copied():
    """The K split's fold lives in split_k.cuh; gemm.cu and the decode body
    call it, and neither carries its own bulk-copy loop."""
    for name in ("gemm.cu", "quant_linear.cu"):
        src = (CSRC / name).read_text()
        assert '#include "split_k.cuh"' in src, name
        assert "splitk::push<" in src and "splitk::done()" in src, name
        assert "bulk_to_peer" not in src, name
