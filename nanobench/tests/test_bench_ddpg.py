"""The DDPG training cell: its work counts reproduce PERF.md's bounds of K9
seeded and K10; at a small size on the CPU, the program's plain twins in
the kernels' place, a sound run is correct and a run broken in each way
the cell can be broken (within an update, between updates, or in the
window) is not; on the card, at the cell's own size, the
program keeps every limit and each control breaks one."""

import time

import pytest
import torch

from nanobench import common, control, harness, work, work_ddpg

CELL = "ddpg400-train-kernel"
SMALL = dict(batch=16, minibatch=32, gradient_steps=2, buffer_days=2)
GRID8 = dict(chargers=8, time_interval_h=1.0, pv=True, battery=True, lookahead=3, different_capacities=True,
             requested_soc=False)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name,piece,ms", [
    ("K9 seeded at B=4096, one 8-charger day", work_ddpg.collect_day_seeded(GRID8, (400, 300), 4096), 0.3903),
    ("K10, 24 steps of 256 samples", work_ddpg.sweep(GRID8, (400, 300), 24, 256), 0.2385),
])
def test_least_times_match_the_kernel_table(name, piece, ms):
    assert round(work.least_ms(piece), 4) == ms, name


def run():
    c = harness.load_cell(CELL, overrides=SMALL)
    torch.manual_seed(0)
    return harness.run_cell(c, 2 ** 31 + 77, 0.05, False, torch.device("cpu"), time.perf_counter())


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]


def patch(monkeypatch, fault):
    from smart_nanogrid_gym_torch.solvers import ddpg

    sweep, collect = ddpg.ddpg_sweep, ddpg.ddpg_collect_day_seeded

    def altered(*args, **kwargs):       # K9's rewards altered where they are produced
        out = list(collect(*args, **kwargs))
        out[2] = out[2] + 0.1
        return tuple(out)

    def half(*args):                    # half of each minibatch left out
        head, batches, tail = args[:6], args[6:11], args[11:]
        M = batches[2].shape[1]
        return sweep(*head, *(x[:, :M // 2] for x in batches), *tail)

    insert = ddpg.DDPGLearner._insert_day

    def stuck(buffer, *rows):           # the insert position never advances: each day overwrites the first
        return insert(buffer, *rows)._replace(insert_pos=buffer.insert_pos)

    if fault == "altered":
        monkeypatch.setattr(ddpg, "ddpg_collect_day_seeded", altered)
    elif fault == "half":
        monkeypatch.setattr(ddpg, "ddpg_sweep", half)
    else:
        monkeypatch.setattr(ddpg.DDPGLearner, "_insert_day", staticmethod(stuck))


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_broken_run_is_not_correct(fault, monkeypatch):
    patch(monkeypatch, fault)
    r = run()
    assert not r["correct"], r["checks"]


def test_stuck_insert_is_not_correct(monkeypatch):
    """A fault only in what one update hands the next (the replay's insert
    position never advances, so each day overwrites the first): the
    reference, which restarts each update from the program's state, agrees
    with every update by itself; the check of what each update carries into
    the next is what finds it."""
    patch(monkeypatch, "stuck")
    checks = run()["checks"]
    assert checks["carry_mismatch"]["value"] > checks["carry_mismatch"]["limit"], checks
    carried = {"carry_gap", "carry_mismatch", "window_nonfinite", "window_unmoved", "window_steps_missed"}
    assert all(v["value"] <= v["limit"] for k, v in checks.items() if k not in carried), checks


@pytest.mark.parametrize("fault", ["unchanged", "nonfinite"])
def test_window_fault_is_not_correct(fault, monkeypatch):
    """The learner broken only from the window's first update on, after the
    updates the reference follows: the check of the window's final state
    still finds it."""
    from smart_nanogrid_gym_torch.solvers import ddpg

    sweep, calls = ddpg.ddpg_sweep, []
    first = harness.load_cell(CELL, overrides=SMALL).traffic["check_updates"]

    def late(*args):
        calls.append(1)
        out = sweep(*args)
        if len(calls) <= first:
            return out
        if fault == "unchanged":
            return (*args[:6], out[6])
        return ([x * float("nan") for x in out[0]], *out[1:])

    monkeypatch.setattr(ddpg, "ddpg_sweep", late)
    r = run()
    assert len(calls) > first
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_control_breaks_a_limit_and_the_program_keeps_them(card):
    c = harness.load_cell(CELL)
    limits = c.traffic["limits"]
    for seed in common.seeds(2 ** 31 + 4343, 3, salt=9):
        r = control.readings(c, seed, 1.0, card, True)
        assert all(v <= limits[k] for k, v in r["program"].items()), r
        for side in set(r) - {"seed", "units", "program"}:
            assert any(not v <= limits[k] for k, v in r[side].items()), (side, r)
    torch.cuda.empty_cache()
