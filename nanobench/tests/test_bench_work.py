"""The work counts reproduce the least times of PERF.md's kernel table
(NVIDIA H100 SXM peaks) at its shapes."""

import pytest

from nanobench import work

GRID8 = dict(chargers=8, time_interval_h=1.0, pv=True, battery=True, lookahead=3, different_capacities=True,
             requested_soc=False)
GRID4 = dict(GRID8, chargers=4)


@pytest.mark.parametrize("name,piece,ms", [
    ("K8 at B=4096 x 20 days", work.rbc_days(GRID8, 4096, 20), 0.0201),
    ("K2 at B=4096, one day", work.collect_day(GRID8, (64, 64), 4096), 0.0370),
    ("K3, 40 steps of 24,576 samples", work.sweep(GRID8, (64, 64), 4096, 10, 4), 0.9653),
    ("K6 64x64 at 4 chargers, B=4096 x 20 days", work.policy_days(GRID4, (64, 64), 4096, 20), 0.3324),
])
def test_least_times_match_the_kernel_table(name, piece, ms):
    assert round(work.least_ms(piece), 4) == ms, name


def test_shapes_and_counts():
    assert work.day_dims(GRID8) == (24, 8, 25, 9)
    assert work.mlp_flops(25, 9, 64, 64) == 12544
    assert work.philox_calls_per_day(GRID8) == 187
    assert work.param_count(25, 9, 64, 64) == 12307
    assert work.bound(3.35e12, 0.0) == (1000.0, "bytes")
    assert work.bound(0.0, 67e12)[1] == "operations" and abs(work.bound(0.0, 67e12)[0] - 1000.0) < 1e-9
