"""CPU checks of the layer-chain A/B tool (``tools/chain_ab.py``) and of
``chip_smoke.py``'s race check of the GPT chain under programmatic
dependent launch.

The tool times whole ``decode_block`` / ``prefill_block`` calls of
several builds on the card; its chains, its switch of ``layer.cu``'s
``GPT_NORM_PDL`` and the kernel names its profiled sums take are pinned
here.  The race check (``chain_race_check``, ``gpt_race_checks``) runs on
the CPU through the plain versions at a tiny size, and must catch a call
that differs from the first on its input.  No card needed."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chain_ab as ab  # noqa: E402
import chip_smoke as cs  # noqa: E402

CSRC = ROOT / "paddle_tpu_torch" / "kernels" / "csrc"


def test_no_pdl_switch_edits_layer_cu_once():
    src = (CSRC / "layer.cu").read_text()
    edited = ab._edited(src, ab.NO_PDL)
    assert "GPT_NORM_PDL = false;" in edited and edited != src
    assert all((CSRC / f).is_file() for f in ab.CHAIN_FILES)


def test_every_pdl_kernel_waits_and_the_llama_norm_does_not():
    """The kernels the GPT chain launches under a programmatic dependency
    (layer_norm_rows, gemm_xw's body, wo_wgmma, wo_dec) run pdl_wait; the
    RMS norm's code is the LayerNorm's with the wait compiled out."""
    for f, n in (("gemm.cu", 2), ("quant_linear.cu", 4), ("rms_norm.cu", 2)):
        assert (CSRC / f).read_text().count("pdl_wait();") == n, f
    rms = (CSRC / "rms_norm.cu").read_text()
    assert "if constexpr (LN) pdl_trigger();" in rms
    assert "if (ln && launch_pdl())" in rms


def test_chains_and_their_profiled_kernels():
    assert ab.CHAINS == {"gpt": ("gpt", False), "gpt_q8": ("gpt", True),
                         "llama": ("llama", False),
                         "llama_q8": ("llama", True)}
    rec = {"void pt::rmsn::layer_norm_rows_kernel<bf16, 1>": (0.002, 2.0),
           "void pt::xw::gemm_xw_small_m_tma<Cfg<2, 8, 6, 2>>": (0.005, 4.0),
           "void pt::rope_kv_write_kernel<bf16, 8, false>": (0.0017, 1.0),
           "void pt::paged_attention_rows<bf16>": (0.006, 1.0)}
    got = ab.chain_sum_ms("gpt", False, "decode", rec)
    assert got == pytest.approx(2 * 0.002 + 4 * 0.005 + 0.0017 + 0.006)
    with pytest.raises(cs.SmokeFailure):      # the prefill GEMM is missing
        ab.chain_sum_ms("gpt", False, "prefill Ts 256", rec)


def test_race_check_catches_a_differing_call(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "RACE_CALLS", 6)
    xs = [torch.ones(2, 3), torch.full((2, 3), 2.0)]
    refs = [(x, x) for x in xs]
    cs.chain_race_check("same", lambda x: x.clone(), xs, refs, 1e-4)
    calls = []

    def stale(x):                   # the fourth call reads the other input
        calls.append(x)
        return xs[0].clone() if len(calls) == 4 else x.clone()
    with pytest.raises(cs.SmokeFailure, match="calls \\[3\\]"):
        cs.chain_race_check("stale", stale, xs, refs, 1e-4)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8_kv8"])
def test_gpt_race_checks_run_on_the_plain_path(monkeypatch, quant):
    """The smoke's GPT race check, decode and a Ts 256 chunk, at a tiny
    GPT on the CPU (the plain versions), bf16 and int8 weights over int8
    pools."""
    from paddle_tpu_torch.models import gpt as tgpt
    from paddle_tpu_torch.ops import decode_block as db
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "RACE_CALLS", 4)
    cfg = dataclasses.replace(tgpt.gpt_tiny(dtype="bfloat16"),
                              max_position_embeddings=1024)
    gen = torch.Generator()
    gen.manual_seed(0)
    BS, NB, MB, bf = 16, 256, 64, torch.bfloat16
    spec = (db.decode_block_spec(cfg, BS, "int8", -1) if quant
            else db.decode_block_spec(cfg, BS))
    lp32 = cs.make_layer(cfg, gen, torch.float32, "cpu",
                         tgpt.block_shapes(cfg))
    lp = cs.export_layer({k: v.to(bf) for k, v in lp32.items()},
                         "int8" if quant else None, -1)
    pools = [torch.randn(NB, BS, cfg.num_heads, cfg.head_dim, generator=gen)
             for _ in range(2)]
    pk, pv = ((cs.q8_pool(p, bf) if quant else p.to(bf)) for p in pools)
    perm = torch.randperm(NB, generator=gen).to(torch.int32)
    lengths, bt, bt_row = cs.serving_tables(perm, BS, MB)
    cs.gpt_race_checks("tiny", spec, lp, pk, pv, bt, lengths, bt_row, NB,
                       gen, cs.TOL["bfloat16"], "cpu")
