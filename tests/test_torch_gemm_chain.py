"""CPU checks of what reads the serving chain's GEMM kernels by name.

``chip_smoke.py``'s ``chain_ms`` sums a layer call's device time from the
profiler's kernel names, and ``tools/gemm_ab.py`` builds variants of
``kernels/csrc/gemm.cu`` by text edits.  Both break silently when the
kernel source moves on (an old name matches nothing and the layer rows
lose their times; an edit that no longer applies times the unedited
kernel), so they are pinned here against the source.  No card needed."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import gemm_ab  # noqa: E402

GEMM_CU = ROOT / "paddle_tpu_torch" / "kernels" / "csrc" / "gemm.cu"
SMALL = ("void pt::xw::gemm_xw_small_m_tma<pt::xw::Cfg<(int)8, (int)6, "
         "(int)2>>(pt::xw::Args, CUtensorMap_st, CUtensorMap_st, "
         "CUtensorMap_st)")
TILED = SMALL.replace("small_m_tma", "tiled_wg").replace("(int)8", "(int)256")


def _breakdown(gemm):
    """A profiler breakdown of one layer call: {kernel: (mean ms a launch,
    launches a call)}."""
    return {"void pt::rms_norm_rows<float>(...)": (0.01, 2.0),
            gemm: (0.05, 6.0),
            "void pt::rope_kv_write<float>(LayerArgs)": (0.02, 1.0),
            "void pt::paged_attention<float>(LayerArgs)": (0.1, 1.0)}


@pytest.mark.parametrize("name,gemm", [("gemm_xw_small_m_tma", SMALL),
                                       ("gemm_xw_tiled_wg", TILED)])
def test_chain_ms_sums_the_chain_with_the_regimes_gemm(name, gemm):
    got = cs.chain_ms(_breakdown(gemm), name)
    assert got == pytest.approx(2 * 0.01 + 6 * 0.05 + 0.02 + 0.1)


def test_chain_ms_weighs_the_gemm_instances_by_their_launches():
    """A layer whose four GEMMs run on three tile instances (two launches
    of one): each instance's mean weighs by its recorded launches."""
    by = _breakdown(SMALL)
    del by[SMALL]
    inst = [TILED, TILED.replace("(int)256", "(int)64"),
            TILED.replace("(int)256", "(int)32")]
    by.update({inst[0]: (0.01, 2.0), inst[1]: (0.006, 1.0),
               inst[2]: (0.009, 0.95)})
    got = cs.chain_ms(by, "gemm_xw_tiled_wg",
                      {"rms_norm_rows": 2, "gemm_xw_tiled_wg": 4,
                       "rope_kv_write": 1, "paged_attention": 1})
    gemms = 4 * (0.02 + 0.006 + 0.009 * 0.95) / 3.95
    assert got == pytest.approx(2 * 0.01 + gemms + 0.02 + 0.1)


@pytest.mark.parametrize("missing", range(4))
def test_chain_ms_fails_without_a_kernel_of_the_chain(missing):
    by = _breakdown(SMALL)
    del by[list(by)[missing]]
    with pytest.raises(cs.SmokeFailure, match="no profiler record"):
        cs.chain_ms(by, "gemm_xw_small_m_tma")


@pytest.mark.parametrize("other", [
    TILED, "void pt::gemm_bf16_small_m<true>(...)",
    "void pt::gemm_bf16_tiled<false>(...)"])
def test_chain_ms_fails_on_another_gemm_kernel(other):
    by = _breakdown(SMALL)
    by[other] = (0.05, 1.0)
    with pytest.raises(cs.SmokeFailure, match="GEMM kernel"):
        cs.chain_ms(by, "gemm_xw_small_m_tma")


def test_gemm_source_has_the_profiled_names_and_no_wmma():
    src = GEMM_CU.read_text()
    for name in ("gemm_xw_small_m_tma", "gemm_xw_tiled_wg"):
        assert f"__global__ void __launch_bounds__(C::THREADS, C::MINB)\n" \
               f"    {name}(" in src, name
    assert "wmma" not in src and "<mma.h>" not in src


@pytest.mark.parametrize("variant", sorted({**gemm_ab.TUNINGS,
                                            **gemm_ab.ABLATIONS}))
def test_gemm_ab_edits_apply_to_the_source(variant):
    cuts = {**gemm_ab.TUNINGS, **gemm_ab.ABLATIONS}[variant]
    src = GEMM_CU.read_text()
    edited = gemm_ab._edited(src, cuts)
    assert edited != src


def test_gemm_ab_times_the_gpt_layers_gemms_and_checks_every_split():
    """``--chain gpt`` times GPT-125M's four GEMMs (the qkv product stored
    split, and row-major beside it) at M 4 and 256; the checked cases
    hold the bias epilogues at GPT-125M's widths and the qkv split at D
    32, 64 and 128."""
    gpt = {label: (K, N, epi) for label, K, N, epi in gemm_ab.CHAINS["gpt"]}
    assert gpt == {"qkv": (768, 2304, "bias_qkv"),
                   "proj": (768, 768, "bias_resid"),
                   "fc1": (768, 3072, "bias_gelu"),
                   "fc2": (3072, 768, "bias_resid"),
                   "qkv_rowmajor": (768, 2304, "bias")}
    assert gemm_ab.GPT_ROWS == (4, 256)
    epis = {epi for *_, epi in gemm_ab.CASES}
    assert {"bias_qkv", "bias_qkv32", "bias_qkv128", "bias_resid",
            "bias_gelu"} <= epis
    assert {gemm_ab.QKV_D[e] for e in epis if e in gemm_ab.QKV_D} == {
        32, 64, 128}


@pytest.mark.parametrize("epi,nbytes", [
    ("none", 2 * (4 * 8 + 8 * 16 + 4 * 16)),
    ("resid", 2 * (4 * 8 + 8 * 16 + 2 * 4 * 16)),
    ("bias_qkv", 2 * (4 * 8 + 8 * 16 + 4 * 16 + 16)),
    ("bias_resid", 2 * (4 * 8 + 8 * 16 + 2 * 4 * 16 + 16)),
    ("swiglu", 2 * (4 * 8 + 2 * 8 * 16 + 4 * 16))])
def test_gemm_ab_bound_counts_each_operand_once(epi, nbytes):
    got, ops = gemm_ab.bytes_ops(4, 8, 16, epi)
    assert got == nbytes
    assert ops == 2 * 4 * 8 * 16 * (2 if epi == "swiglu" else 1)
