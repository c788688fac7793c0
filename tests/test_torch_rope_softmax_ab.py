"""CPU checks of the RoPE / KV-write and softmax-mask A/B tool's cases and
byte counts.

``tools/rope_softmax_ab.py`` and ``chip_smoke.py`` time
``rope_kv_write`` and ``softmax_mask_fwd`` on the card beside bounds
computed from their shapes, and check them on case lists chosen to reach
every path of the two kernels.  The lists and the byte counts are pinned
here, so that a bound or a case cannot drift unseen.  No card needed."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import rope_softmax_ab as ab  # noqa: E402

CSRC = ROOT / "paddle_tpu_torch" / "kernels" / "csrc"
HQ, HKV, D = 32, 32, 128                    # llama_7b


def test_tool_builds_the_two_kernel_files():
    assert all((CSRC / f).is_file() for f in ab.FILES)
    for f, name in zip(ab.FILES, ("rope_kv_write", "softmax_mask_fwd")):
        src = (CSRC / f).read_text()
        assert f"count_launch(CNT_{name.upper()}," in src
        assert "__global__ void __launch_bounds__" in src


def test_rope_cases_cover_the_layers_head_dims_and_groups():
    assert sorted(ab.ROPE_GD) == [(d, g) for d in (32, 64, 128)
                                  for g in (1, 2, 4, 8)]
    assert ab.ROPE_CHUNKS == (16, 256)


@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_rope_check_targets_drop_what_the_contract_drops(mode):
    """The small check cases write from 2 decode slots (the inactive slot,
    the length past the table and the page >= NB drop) and 5 prefill rows
    (the padded tail routed to page NB drops)."""
    bt = torch.full((5, 3), -1, dtype=torch.int32)
    bt[0, :2] = torch.tensor([3, 7])
    bt[1, 0] = 9
    bt[3] = torch.tensor([1, 2, 4])
    bt[4, 0] = 24 + 3
    pool = torch.zeros(24, 4, 2, 8)
    if mode == "decode":
        tgt = dict(block_table=bt, lengths=torch.tensor([5, 0, 0, 12, 2],
                                                        dtype=torch.int32))
        assert cs.rope_kv_writes(tgt, pool) == 2
    else:
        blk = torch.tensor([5, 5, 8, 8, 8, 24, 24], dtype=torch.int32)
        assert cs.rope_kv_writes(dict(block_table=bt[0], blk=blk, off=blk % 4),
                                 pool) == 5


def test_rope_kv_cases_and_bounds_at_llama_widths():
    """The decode case (lengths 1000/37/0/517, slot 2 inactive) writes 3
    rows; the prefill chunks after 300 positions write every row through
    blk / off; Ts 256 moves 14.8 MB, a 0.00442 ms bound at 3.35 TB/s."""
    BS, MB = 16, 256
    lengths = torch.tensor([1000, 37, 0, 517], dtype=torch.int32)
    bt = torch.full((4, MB), -1, dtype=torch.int32)
    for b, n in enumerate(lengths.tolist()):
        if b != 2:
            bt[b, :-(-(n + 1) // BS)] = torch.arange(-(-(n + 1) // BS)) + b
    bt_row = torch.full((MB,), -1, dtype=torch.int32)
    bt_row[:38] = torch.arange(38) + 100
    tab = torch.randn(4096, D)
    cases = cs.rope_kv_cases(lengths, bt, bt_row, tab, tab, BS,
                             ab.ROPE_CHUNKS)
    assert list(cases) == ["decode", "prefill Ts 16", "prefill Ts 256"]
    pool = torch.zeros(256, BS, HKV, D)
    M, tgt, c, s = cases["decode"]
    assert M == 4 and c.shape == (4, D)
    assert cs.rope_kv_writes(tgt, pool) == 3
    nbytes, ops = cs.rope_kv_bytes_ops(4, HQ, HKV, D, 3)
    assert nbytes == (4 * (HQ + 2 * HKV) * D + 2 * 4 * D
                      + 4 * (HQ + HKV) * D + 3 * 2 * HKV * D) * 2
    assert ops == 6 * 4 * (HQ + HKV) * D
    M, tgt, c, s = cases["prefill Ts 256"]
    pos = 300 + torch.arange(256)
    assert torch.equal(tgt["blk"], bt_row[pos // BS])
    assert torch.equal(tgt["off"], (pos % BS).to(torch.int32))
    assert torch.equal(c, tab[pos])
    assert cs.rope_kv_writes(tgt, pool) == 256
    nbytes, _ = cs.rope_kv_bytes_ops(256, HQ, HKV, D, 256)
    assert nbytes == 14_811_136
    assert cs.bound_ms(*cs.rope_kv_bytes_ops(256, HQ, HKV, D, 256))[0] == \
        pytest.approx(0.004421, abs=1e-6)


def test_softmax_cases_reach_every_path_and_broadcast():
    widths = {xs[-1] for _, xs, _, _ in ab.SOFTMAX_CASES}
    assert {1, 7, 127, 128, 129, 1000, 5000} <= widths
    for label, xs, ms, extra in ab.SOFTMAX_CASES:
        assert torch.broadcast_shapes(xs, ms) == xs, label
    kinds = {label.split(" ", 1)[1] for label, *_ in ab.SOFTMAX_CASES
             if " " in label}
    assert {"heads", "rows", "heads rows", "columns", "full",
            "heads strided", "full strided"} <= kinds
    # rows that are not a multiple of the rows a warp takes at once (16
    # bf16 rows of 128: 4 lane groups of 4 rows)
    assert any((torch.Size(xs).numel() // xs[-1]) % 16
               for _, xs, _, _ in ab.SOFTMAX_CASES if xs[-1] == 128)


def test_softmax_timed_shapes_and_main_bound():
    assert [t[0] for t in ab.SOFTMAX_TIMED] == ["main", "S 1000", "S 5000"]
    label, xs, ms = ab.SOFTMAX_TIMED[0]
    assert (xs, ms) == ((32, 12, 128, 128), (32, 1, 128, 128))
    nbytes, ops = ab.softmax_bytes_ops(xs, ms)
    assert nbytes == 2 * xs[0] * 12 * 128 * 128 * 2 + 32 * 128 * 128 * 4
    assert ops == 6 * 32 * 12 * 128 * 128
    assert cs.bound_ms(nbytes, ops, dtype="float32") == pytest.approx(
        (0.0081382, "bytes"), abs=1e-7)


@pytest.mark.parametrize("variant", sorted(ab.TUNINGS))
def test_tunings_apply_to_the_source(variant):
    """Each tuning edits this tree's file (an edit that no longer applies
    would time the unedited kernel under the tuning's name)."""
    src = (CSRC / ab.tuned_file(variant)).read_text()
    edited = ab._edited(src, ab.TUNINGS[variant])
    assert edited != src


@pytest.mark.parametrize("variant", sorted(ab.ABLATIONS))
def test_ablations_apply_to_the_source(variant):
    """Each cut-down int8-pool kernel edits this tree's rope_kv.cu."""
    assert ab.tuned_file(variant) == "rope_kv.cu"
    src = (CSRC / "rope_kv.cu").read_text()
    assert ab._edited(src, ab.ABLATIONS[variant]) != src


def test_q8_variants_edit_the_int8_kernel_file():
    q8 = [n for n in {**ab.TUNINGS, **ab.ABLATIONS} if n.startswith("q8")]
    assert {"q8_v16", "q8_kv_together", "q8_kv_apart", "q8_128",
            "q8_div_ieee", "q8_no_div",
            "q8_no_shuffle", "q8_no_scale_store", "q8_rcp_only"} == set(q8)
    assert all(ab.tuned_file(n) == "rope_kv.cu" for n in q8)
    src = (CSRC / "rope_kv.cu").read_text()
    assert "count_launch(CNT_ROPE_KV_WRITE_Q8," in src
    assert src.count(ab.Q8_CODE) == 1 and src.count(ab.Q8_SHUFFLE) == 1
    assert src.count(ab.Q8_SHUFFLE_PACKED) == 1


@pytest.mark.parametrize("rotated, M, writes, want", [
    (True, 4, 3, 0.00006), (True, 256, 256, 0.00381),
    (False, 4, 3, 0.000005), (False, 256, 256, 0.00036)])
def test_q8_bounds_match_chip_smoke(rotated, M, writes, want):
    """The four timed instances' bounds: a byte a code and 4 bytes a
    scale stored, k and v (and, rotated, q and cos / sin) read once, as
    chip_smoke.py counts them: llama_7b rotated (32 + 32 heads, D 128) and
    GPT-125M unrotated (12 kv heads, D 64), decode (3 rows keep their
    write) and Ts 256."""
    if rotated:
        nbytes, ops = ab.q8_bytes_ops(M, HQ, HKV, D, writes, True)
        b0, o0 = cs.rope_kv_bytes_ops(M, HQ, HKV, D, 0)
        assert nbytes == b0 + writes * 2 * HKV * (D + 4)
        assert ops == o0 + writes * 2 * HKV * 3 * D
    else:
        H, Dg = ab.GPT_HEADS, ab.GPT_D
        nbytes, ops = ab.q8_bytes_ops(M, H, H, Dg, writes, False)
        assert nbytes == 2 * M * H * Dg * 2 + writes * 2 * H * (Dg + 4)
        assert ops == writes * 2 * H * 3 * Dg
    assert cs.bound_ms(nbytes, ops)[0] == pytest.approx(want, rel=0.1)


def test_q8_hard_rows_hold_their_kinds():
    """Ties land on half-integer quotients, clipped rows carry their
    absmax at both signs, the zero row is zero, tiny rows stay under the
    1e-8 floor and floor rows just above it."""
    import numpy as np
    n = len(cs.Q8_HARD_KINDS)
    x = cs.q8_hard_rows(8 * n, 64, 5)
    for i, row in enumerate(x):
        kind = cs.Q8_HARD_KINDS[i % n]
        a = np.abs(row).max()
        q = row / (np.maximum(a, np.float32(1e-8)) / np.float32(127))
        if kind == "tie":
            assert (np.abs(q - np.trunc(q)) == 0.5).sum() >= 60
        elif kind == "clip":
            assert (row == a).sum() >= 2 and (row == -a).sum() >= 2
        elif kind == "zero":
            assert not row.any()
        elif kind == "tiny":
            assert 0 < a < 1e-8
        elif kind == "floor":
            assert 1e-8 < a < 1.1e-8
