"""Tracing helpers (port of ``utils/profiling.py``).

The reference's only observability is wall-clock prints around training
(solvers/RL/ppo_train.py:99-112).  Here: named spans at the port's layer
boundaries, recorded only while a ``torch.profiler`` runs, and a
``torch.profiler`` trace around any block of code, written as a Chrome
trace (Perfetto, ``chrome://tracing``) in which those spans show.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
from torch.profiler import ProfilerActivity, record_function

SPAN_PREFIX = "ng."
_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """The span ``ng.<name>`` around a block: a ``record_function`` while a
    ``torch.profiler`` runs, so it lands in the profiler's trace on the
    clock of its device records and nests in the span around it; otherwise
    one shared null context, which records nothing."""
    return record_function(SPAN_PREFIX + name) if _profiling() else _NULL


def spanned(name: str):
    """Decorator: each call of the function runs inside :func:`span` ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA when
    torch sees a card) and write ``trace.<time>.<pid>.json`` into ``log_dir``;
    yields the profiler, whose ``key_averages()`` sums the block by kernel.
    The port's ``ng.`` spans run inside the block show in the trace."""
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
