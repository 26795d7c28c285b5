"""Run one cell of ``BENCHMARK.json``: set-up, a closed-loop window, the
metrics, and the comparison with the plain reference that decides
``correct``.

A cell names a configuration (``nanobench/configs/<config>.json``) and a
traffic mix (``nanobench/traffic/<traffic>.json``); the mix names its driver
(``nanobench/drivers/<driver>.py``), which sets the cell up, runs one unit of
work, counts it and checks it.  A driver's end-to-end metric, ``END_TO_END``,
is the window's rate (:func:`window_rate`) unless it defines ``end_to_end``.  Each per-layer metric is a reader of its own,
``nanobench/metrics/<name>.py``.  All are found by name, so a later cell or
metric is new files only.
"""

from __future__ import annotations

import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

import torch

from . import trace as tracing
from .spans import span

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the namespaces of the program's hand-written kernels (csrc/*.cuh)
HAND_KERNEL = re.compile(r"\bng[a-z]::")
JAX_NAMES = ("jax", "jaxlib", "flax", "optax", "orbax", "smart_nanogrid_gym_tpu")


class Unit(NamedTuple):
    start: float   # host seconds
    end: float
    steps: int     # env-steps the unit scored or trained on
    traced: bool


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: ModuleType
    end_to_end: list
    per_layer: list


class Ctx(NamedTuple):
    """What a driver's set-up is given."""

    root: Path
    config: dict
    traffic: dict
    seed: int
    device: torch.device


class Readout(NamedTuple):
    """What a metric reader is given: the untraced and the traced units, the
    trace of the traced ones (None when it failed its count), the work of
    one unit by piece (``work.py``'s counts), the driver's state and the
    cell's files."""

    units: list
    traced: list
    trace: object
    work: dict
    state: object
    config: dict
    traffic: dict


def load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(workload: str, root: Path = ROOT, overrides: dict | None = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files;
    ``overrides`` replaces traffic parameters (the tests' small sizes)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    traffic.update(overrides or {})
    driver = load_module(HERE / "drivers" / f"{traffic['driver']}.py", f"nanobench_driver_{traffic['driver']}")

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return Cell(workload, int(w["chips"]), config, traffic, driver,
                [m for m in bench["end_to_end"] if mine(m)], [m for m in bench["per_layer"] if mine(m)])


def reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", "nanobench_metric_" + name.replace(".", "_")).read


def hand_launches() -> int:
    from smart_nanogrid_gym_torch.ops import _build

    return sum(_build.launch_counts.values())


# a traced run profiles up to this many runs of ``trace_units`` units in
# turn, until one keeps a record of every hand-kernel launch
TRACE_TRIES = 3


def _window(cell: Cell, state, seconds: float, traced_run: bool, device: torch.device):
    """Units until ``seconds`` have passed, and in a traced run the trace of
    ``trace_units`` units from the second half of the window with whether
    it stands (:func:`checked_trace`): the profiler has dropped a kernel's
    record before, and then the next units are profiled instead."""
    drv = cell.driver
    want = int(cell.traffic.get("trace_units", 1)) if traced_run else 0
    tries = TRACE_TRIES if traced_run else 0
    units, prof, launches, n, trace, sound = [], None, 0, 0, None, False
    start = time.perf_counter()
    while not units or time.perf_counter() - start < seconds:
        traced = prof is not None or (tries > 0 and not sound and time.perf_counter() - start >= seconds / 2)
        if traced and prof is None:
            launches, n = hand_launches(), 0
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        t0 = time.perf_counter()
        with span("unit"):
            steps = drv.unit(state)
        units.append(Unit(t0, time.perf_counter(), steps, traced))
        if traced:
            n += 1
            if n == want:
                prof.stop()
                trace, sound = checked_trace(prof, hand_launches() - launches, n)
                prof, tries = None, tries - 1
    if prof is not None:
        prof.stop()
        trace, sound = checked_trace(prof, hand_launches() - launches, n)
    return units, trace, sound


def window_rate(units: list) -> float:
    """Every step of the window's units over the time from the first unit's
    start to the last one's end: a rate taken over all the window's work."""
    return sum(u.steps for u in units) / (units[-1].end - units[0].start)


def checked_trace(prof, launches: int, n_traced: int):
    """The trace of the traced units and whether its device metrics stand:
    not when the profiler lost a hand kernel's record (its count of them
    disagrees with the program's launch counter)."""
    trace = tracing.read(prof)
    lo, hi = trace.window
    linked = sum(1 for op in trace.ops if op.launched >= 0)
    print(f"nanobench: trace of {n_traced} units: {len(trace.ops)} device ops, {linked} linked to a host launch, "
          f"{len(trace.spans)} spans", file=sys.stderr)
    seen = sum(1 for op in trace.ops if HAND_KERNEL.search(op.name) and lo <= op.start <= hi)
    if seen != launches:
        print(f"nanobench: the trace holds {seen} hand-kernel records, the program launched {launches}: "
              "the device metrics of this run are left out", file=sys.stderr)
        return trace, False
    return trace, True


def jax_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_NAMES))


def run_cell(cell: Cell, seed: int, seconds: float, traced_run: bool, device: torch.device,
             started: float, root: Path = ROOT) -> dict:
    """One run of ``cell``; returns the result line's object (``checks``
    last) and prints each compared number beside its limit on stderr."""
    drv = cell.driver
    state = drv.setup(Ctx(root, cell.config, cell.traffic, int(seed), device))
    if traced_run and device.type == "cuda":  # the profiler's own start-up, outside the window
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - started
    units, trace, sound = _window(cell, state, seconds, traced_run, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    metrics, dev, extra = {}, {}, {}
    if traced_run:
        traced = [u for u in units if u.traced]
        ro = Readout([u for u in units if not u.traced], traced, trace if sound else None, drv.work(state), state,
                     cell.config, cell.traffic)
        for m in cell.per_layer:
            value = reader(m["name"])(ro)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if trace is not None:
            lo, hi = trace.window
            dev = {"busy_s": tracing.union_ns(trace.ops, lo, hi) / 1e9, "window_s": (hi - lo) / 1e9}
            extra["breakdown"] = tracing.breakdown(trace)
    else:
        values = drv.end_to_end(units, state) if hasattr(drv, "end_to_end") else {drv.END_TO_END: window_rate(units)}
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    del trace

    outputs = drv.finish(state)
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check(cell.config, cell.traffic, int(seed), outputs, root, device)
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    for name, (v, lim) in checks.items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak), **dev}
    return {"correct": bool(correct), "attempted": len(units), "failed": 0 if correct else len(units),
            "metrics": metrics, "device": device_info, **extra,
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}
