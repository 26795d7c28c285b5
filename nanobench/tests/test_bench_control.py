"""On the card, at each cell's own size: the program's readings stay within
their limits, and the control (the plain reference in the next precision
below the configuration's, in the program's place), and for the training
cell the TF32 sweep alone, the program's bf16 sweep and the planted fault,
each break a limit.  Run with
``python3 -m pytest nanobench/tests/test_bench_control.py -m cuda`` on the card;
``python3 -m nanobench.control`` prints the readings the limits were set from."""

import pytest
import torch

from nanobench import common, control, harness

pytestmark = pytest.mark.cuda

CELLS = ["ppo64-train-kernel", "rbc8-eval-10kdays", "ppo64-eval-10kdays", "ppo64-vecenv-1024"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_breaks_a_limit_and_the_program_keeps_them(cell, card):
    c = harness.load_cell(cell)
    limits = c.traffic["limits"]
    for seed in common.seeds(2 ** 31 + 4242, 3, salt=9):
        r = control.readings(c, seed, 1.0, card, True)
        assert all(v <= limits[k] for k, v in r["program"].items()), r
        for side in set(r) - {"seed", "units", "program"}:
            assert any(not v <= limits[k] for k, v in r[side].items()), (side, r)
    torch.cuda.empty_cache()
