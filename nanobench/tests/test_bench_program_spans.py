"""``nanobench/program_spans.py`` on synthetic traces: each idle nanosecond
of a unit goes to the innermost ``ng.`` span, the shares and the unspanned
time add up to ``readers.host_ms``, each kernel goes to the span around its
host launch, and a reader gives None where its span never occurs."""

import random

import pytest

from nanobench import harness, program_spans, readers
from nanobench.trace import DeviceOp, Span, Trace


def ng(start, end, name):
    return Span(start, end, "ng." + name)


def readout(units, host, ops):
    spans = sorted(Span(s, e, "nb.unit") for s, e in units)
    trace = Trace(sorted(ops), spans, sorted(host), (spans[0].start, spans[-1].end))
    return harness.Readout([], spans, trace, {}, None, {}, {})


# one PPO update in [0, 100) ns, as the learner's spans nest
UPDATE = [ng(5, 95, "ppo.update"), ng(10, 20, "ppo.draw"), ng(20, 40, "collect"), ng(30, 32, "launch"),
          ng(40, 60, "ppo.gae"), ng(60, 90, "sweep"), ng(80, 82, "launch"), Span(41, 44, "aten::mul")]
KERNELS = [DeviceOp(35, 45, "ngc::ppo_collect_day_kernel", 31), DeviceOp(50, 52, "elementwise_kernel", 45),
           DeviceOp(55, 57, "elementwise_kernel", 50), DeviceOp(85, 99, "ngs::ppo_sweep_kernel", 81),
           DeviceOp(45, 46, "Memcpy HtoD", 42)]
TRAIN = readout([(0, 100)], UPDATE, KERNELS)
# idle: [0,35) [46,50) [52,55) [57,85) [99,100), given to the innermost span
TRAIN_IDLE = {None: 5 + 1, "ng.ppo.update": 5, "ng.ppo.draw": 10, "ng.collect": 10 + 3, "ng.launch": 2 + 2,
              "ng.ppo.gae": 4 + 3 + 3, "ng.sweep": 20 + 3}


def test_idle_goes_to_the_innermost_span():
    assert dict(program_spans.idle_split(TRAIN.trace, TRAIN.traced)) == TRAIN_IDLE


@pytest.mark.parametrize("spans, at, want", [
    ([ng(0, 100, "a"), ng(0, 50, "b")], 20, "ng.b"),            # the same start: the shorter
    ([ng(0, 100, "a"), ng(10, 90, "b")], 50, "ng.b"),           # the later start
    ([ng(0, 100, "a"), ng(10, 30, "b")], 50, "ng.a"),           # back to the outer span after the inner
    ([ng(0, 40, "a"), ng(60, 100, "b")], 50, None),             # between spans: unspanned
])
def test_innermost_is_the_latest_start_then_the_shortest(spans, at, want):
    ro = readout([(0, 100)], spans, [DeviceOp(0, at, "k", -1), DeviceOp(at + 1, 100, "k", -1)])
    split = program_spans.idle_split(ro.trace, ro.traced)
    assert dict(split) == {want: 1}


def random_readout(seed):
    rng = random.Random(seed)
    units = [(u * 1000, u * 1000 + rng.randint(500, 1000)) for u in range(3)]
    host = []

    def nest(lo, hi, depth):
        t = lo
        while depth < 4 and t < hi - 10 and rng.random() < 0.8:
            s = rng.randint(t, hi - 10)
            e = rng.randint(s + 1, hi)
            host.append(ng(s, e, rng.choice(["a", "b", "c"])))
            nest(s, e, depth + 1)
            t = e
    for lo, hi in units:
        nest(lo - 20, hi + 20, 0)
    ops = []
    for _ in range(rng.randint(0, 60)):
        s = rng.randint(-50, 3100)
        ops.append(DeviceOp(s, s + rng.randint(1, 120), "k", rng.randint(-1, 3100)))
    return readout(units, host, ops)


@pytest.mark.parametrize("ro", [TRAIN] + [random_readout(seed) for seed in range(6)])
def test_shares_and_unspanned_add_up_to_host_ms(ro):
    split = program_spans.idle_split(ro.trace, ro.traced)
    assert all(v >= 0 for v in split.values())
    assert sum(split.values()) / len(ro.traced) / 1e6 == pytest.approx(readers.host_ms(ro), rel=1e-12)
    launched = program_spans.launch_split(ro.trace, ro.traced)
    assert sum(launched.values()) == readers.launches(ro) * len(ro.traced)


def test_kernels_go_to_the_span_around_their_launch():
    # K2 and K3 from inside ng.launch, GAE's two from ng.ppo.gae; the copy is no kernel
    assert dict(program_spans.launch_split(TRAIN.trace, TRAIN.traced)) == {"ng.launch": 2, "ng.ppo.gae": 2}


@pytest.mark.parametrize("metric, want", [
    ("draw_idle_ms.train", 10e-6), ("gae_idle_ms.train", 10e-6), ("gae_launches.train", 2.0),
    ("wrap_idle_ms.train", 17e-6 + 23e-6), ("learner_idle_ms.train", 5e-6),
    ("guard_idle_ms.eval", None), ("engine_idle_ms.step", None),
])
def test_readers_on_an_update(metric, want):
    got = harness.reader(metric)(TRAIN)
    assert got == (None if want is None else pytest.approx(want))


# two steps of a vector env in [0, 100) and [100, 300); the second ends the day
STEPS = readout([(0, 100), (100, 300)],
                [ng(10, 60, "engine.step"), ng(70, 80, "to_host"), ng(110, 150, "engine.step"),
                 ng(160, 170, "to_host"), ng(180, 290, "vecenv.reset"), ng(185, 260, "generate")],
                [DeviceOp(20, 30, "k", 15), DeviceOp(120, 125, "k", 115), DeviceOp(200, 210, "k", 190),
                 DeviceOp(263, 268, "k", 262), DeviceOp(270, 280, "k", 265)])


@pytest.mark.parametrize("metric, want", [
    ("engine_idle_ms.step", (40 + 35) / 2 * 1e-6), ("to_host_idle_ms.step", (10 + 10) / 2 * 1e-6),
    ("generate_idle_ms.step", 65e-6),      # a reset: [185, 260) less the kernel at 200
    ("reset_launches.step", 3.0),          # launched at 190 (generate), 262 and 265 (the reset)
])
def test_readers_on_steps_and_a_day_end_reset(metric, want):
    assert harness.reader(metric)(STEPS) == pytest.approx(want)


def test_none_without_a_trace_and_zero_for_a_span_without_idle_time():
    no_trace = TRAIN._replace(trace=None)
    assert harness.reader("gae_idle_ms.train")(no_trace) is None
    assert harness.reader("gae_launches.train")(no_trace) is None
    busy = readout([(0, 100)], [ng(10, 20, "guard")], [DeviceOp(0, 100, "k", 5)])
    assert harness.reader("guard_idle_ms.eval")(busy) == 0.0
    assert harness.reader("wrap_idle_ms.eval")(busy) is None
