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


def test_prefill_body_splits_k_and_the_old_launcher_is_gone():
    """wo_wgmma covers the card at small M by a K split over a cluster,
    folded through split_k.cuh; its launcher plans the tile rows and the
    split from the card's residency and caches its tensor maps, so the
    per-call map encoding and shared-memory attribute are gone."""
    src = QL_CU.read_text()
    for old in ("launch_wgmma", "const bool narrow", "launch_rows<",
                "cudaFuncSetAttribute(\n      wo_wgmma"):
        assert old not in src, old
    assert "splitk::push<C::BM>(red, recv, recv_bar, S, rank, tid);" in src
    assert "static splitk::ResidencyTable<WG_INSTS> wg_residency;" in src
    body = src[src.index("cudaError_t launch_prefill(const WoArgs *a"):]
    body = body[:body.index("\n}\n")]
    assert "splitk::cached_map_2d" in body and "encode_map_2d" not in body
    assert 'extern "C" int pt_wo_plan(const WoArgs *a, int *out)' in src
    for width in ("INT8", "INT4"):
        for kind in ("CNT_WO", "CNT_WO_LAYER"):
            assert (f"count_launch({kind}_{width}_TILED, launch_prefill(a, s))"
                    in src), (kind, width)


def test_chain_cases_are_the_layers_gemms():
    """The chain's M-256 timings cover a llama_7b layer's seven GEMMs in
    int8 and int4 and a GPT-125M layer's four, with their epilogues."""
    fams = {(fam, width, gs): mats for fam, width, gs, mats in wo_ab.CHAIN}
    for width in ("int8", "int4"):
        mats = fams[("llama_7b", width, -1)]
        assert [m[3] for m in mats] == ["none", "none", "none", "resid",
                                        "none", "swiglu", "resid"]
        assert [(m[1], m[2]) for m in mats][-1] == (11008, 4096)
    gpt = [k for k in fams if k[0] == "gpt_125m"]
    assert len(gpt) == 2
    assert [m[3] for m in fams[gpt[0]]] == ["bias", "bias_resid",
                                            "bias_gelu", "bias_resid"]
    assert wo_ab.CHAIN_M == 256


def test_chain_times_the_decode_rows_and_the_row_major_qkv_store():
    """The chain's GEMMs are timed at the decode rows (``wo_dec``) as well
    as at M 256, and a qkv product stored split is timed again stored
    row-major, under ``<label>_rowmajor``."""
    import inspect
    assert (wo_ab.CHAIN_M, wo_ab.DEC_M) == (256, 4)
    src = inspect.getsource(wo_ab.time_chain)
    assert 'f"{lab}_rowmajor"' in src and '"qkv_head_dim" in kw' in src
    assert "for M in (CHAIN_M, DEC_M):" in inspect.getsource(wo_ab.main)
