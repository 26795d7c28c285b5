"""Reading a ``torch.profiler`` trace in memory: the device's busy
intervals, its kernels by name, the host spans of the benchmark, and which
host span launched each device operation (by the launch's correlation id).

Only the traced part of a window is read; nothing is written to disk.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SPAN_PREFIX = "nb."


class DeviceOp(NamedTuple):
    start: int      # ns, the profiler's clock
    end: int
    name: str
    launched: int   # ns of the host launch call, -1 when the profiler linked none


class Span(NamedTuple):
    start: int
    end: int
    name: str


class Trace(NamedTuple):
    ops: list          # DeviceOp: kernels, copies and sets on the device
    spans: list        # Span: the benchmark's own record_function spans
    host: list         # Span: the host's operator calls (for naming idle gaps)
    window: tuple      # (start, end) ns of the traced units


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def read(prof) -> Trace:
    """The trace of a stopped ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    launches, spans, host, device = {}, [], [], []
    for e in events:
        name, start, end = e.name(), e.start_ns(), e.start_ns() + e.duration_ns()
        if _is_device(e):
            if not name.startswith(SPAN_PREFIX) and not e.is_user_annotation():
                device.append((start, end, name, e.correlation_id()))
        elif name.startswith(SPAN_PREFIX):
            spans.append(Span(start, end, name))
        elif name.startswith("cuda") or name.startswith("cu"):
            launches[e.correlation_id()] = start
        else:
            host.append(Span(start, end, name))
    ops = sorted(DeviceOp(s, t, n, launches.get(c, -1)) for s, t, n, c in device)
    units = [s for s in spans if s.name == SPAN_PREFIX + "unit"]
    window = (min(s.start for s in units), max(s.end for s in units)) if units else (0, 0)
    return Trace(ops, sorted(spans), sorted(host), window)


def is_kernel(op: DeviceOp) -> bool:
    low = op.name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def union_ns(ops, lo: int, hi: int) -> int:
    """Nanoseconds in ``[lo, hi]`` in which some op of ``ops`` ran."""
    busy, cur_s, cur_e = 0, None, None
    for op in sorted(ops):
        s, e = max(op.start, lo), min(op.end, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def gaps(ops, lo: int, hi: int) -> list[tuple[int, int]]:
    """The idle intervals of the device in ``[lo, hi]``."""
    out, t = [], lo
    for op in sorted(ops):
        if op.start > t:
            out.append((t, min(op.start, hi)))
        t = max(t, op.end)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def spans_named(trace: Trace, name: str) -> list[Span]:
    return [s for s in trace.spans if s.name == SPAN_PREFIX + name]


def launched_in(trace: Trace, spans) -> list[DeviceOp]:
    """The device ops whose host launch lies inside one of ``spans``."""
    out = []
    for op in trace.ops:
        if op.launched >= 0 and any(s.start <= op.launched <= s.end for s in spans):
            out.append(op)
    return out


def breakdown(trace: Trace) -> dict:
    """The ten device ops that took most time, by name, and the ten longest
    idle gaps, each named by the benchmark span and the host operator around
    its middle."""
    lo, hi = trace.window
    by_name: dict[str, float] = {}
    for op in trace.ops:
        if op.end > lo and op.start < hi:
            by_name[op.name] = by_name.get(op.name, 0.0) + (min(op.end, hi) - max(op.start, lo)) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps(trace.ops, lo, hi), key=lambda g: g[0] - g[1])[:10]

    def around(t):
        span = [s.name for s in trace.spans if s.start <= t <= s.end and s.name != SPAN_PREFIX + "unit"]
        op = [h.name for h in trace.host if h.start <= t <= h.end]
        return "/".join(x for x in (span[-1] if span else "", op[-1] if op else "") if x) or "host"

    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[around((s + e) // 2)[:160], (e - s) / 1e9] for s, e in idle]}
