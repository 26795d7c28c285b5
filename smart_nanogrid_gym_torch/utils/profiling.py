"""Tracing/profiling helpers (port of ``utils/profiling.py``).

The reference's only observability is wall-clock prints around training
(solvers/RL/ppo_train.py:99-112).  Here: a ``torch.profiler`` trace around
any block of code, written as a Chrome trace (Perfetto, ``chrome://tracing``),
simple phase timers that wait for the card before they stop the clock, and
a steps/s meter used by the training scripts.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity

from .checkpoint import tree_leaves


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA when
    torch sees a card) and write ``trace.<time>.<pid>.json`` into ``log_dir``;
    yields the profiler, whose ``key_averages()`` sums the block by kernel."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    try:
        yield profiler
    finally:
        profiler.stop()
        profiler.export_chrome_trace(os.path.join(log_dir, f"trace.{int(time.time())}.{os.getpid()}.json"))


def synchronize(tree) -> None:
    """Wait for every card that holds a tensor of the nested ``tree``."""
    for device in {x.device for x in tree_leaves(tree) if isinstance(x, torch.Tensor)}:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates wall-clock per named phase; waits for the card that holds
    ``block_on``'s tensors before it stops the clock."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                synchronize(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }


class ThroughputMeter:
    """env-steps/s over a sliding window of record() calls."""

    def __init__(self):
        self.t0 = None
        self.steps = 0

    def start(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def record(self, n_steps: int):
        if self.t0 is None:
            self.start()
        self.steps += n_steps

    @property
    def steps_per_sec(self) -> float:
        if self.t0 is None or self.steps == 0:
            return 0.0
        return self.steps / (time.perf_counter() - self.t0)
