"""CPU checks of how ``chip_smoke.py`` reads the linear-CE kernels out of a
profiler breakdown.

The profiler can miss kernel records, so a breakdown's counts are not
launch counts: ``lce_kernel`` takes the launches from the kernel library's
counters and the per-launch time from whatever records there are.  No card
needed."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SPLIT_X = "pt::lce::linear_ce_split_x(pt::lce::Args)"
FWD_SPLIT = "pt::lce::linear_ce_fwd_split(pt::lce::Args)"
FWD_WG = "pt::lce::linear_ce_fwd_wg(pt::lce::Args)"


@pytest.mark.parametrize("recorded", [1.0, 0.8, 0.2])
def test_lce_kernel_times_every_launch_when_records_are_missing(recorded):
    """One launch a call, of which the profiler kept ``recorded``: the
    call's time is the launch's mean time, its launches the counter's."""
    got = cs.lce_kernel({SPLIT_X: (0.03, recorded)}, "linear_ce_split_x",
                        0.5, 1)
    assert got["ms"] == pytest.approx(0.03)
    assert got["launches_per_call"] == 1
    assert got["routes"] == ["kernel"]
    assert got["call_ms"] == 0.5


def test_lce_kernel_weighs_instances_by_their_records():
    by = {FWD_SPLIT: (0.2, 3.0), FWD_WG: (0.1, 1.0), SPLIT_X: (0.03, 1.0)}
    got = cs.lce_kernel(by, "linear_ce_fwd", None, 4)
    assert got["ms"] == pytest.approx(4 * (0.2 * 3 + 0.1) / 4)
    assert got["routes"] == ["split", "wg"]


def test_lce_kernel_without_records_has_no_time():
    got = cs.lce_kernel({FWD_WG: (0.1, 1.0)}, "linear_ce_split_x", None, 1)
    assert got["ms"] is None and got["routes"] == []
    assert got["launches_per_call"] == 1


def test_lce_routes_tell_the_split_pre_pass_from_the_split_route():
    by = {FWD_SPLIT: (0.2, 1.0), SPLIT_X: (0.03, 1.0)}
    assert cs.lce_routes(by, "linear_ce_fwd") == ["split"]
    assert cs.lce_routes(by, "linear_ce_split_x") == ["kernel"]
