"""Arithmetic the per-layer metric readers share.  Each reader
(``metrics/<name>.py``) takes a :class:`..harness.Readout` and returns a
number, or None when its run has nothing for it to read; a share of a
roofline or of a peak is never made up as 0."""

from __future__ import annotations

from . import trace as tracing
from . import work as counts


def unit_spans(ro):
    return tracing.spans_named(ro.trace, "unit") if ro.trace is not None else []


def device_idle(ro):
    """Percent of the traced window in which nothing ran on the device."""
    if ro.trace is None:
        return None
    lo, hi = ro.trace.window
    return 100.0 * (1.0 - tracing.union_ns(ro.trace.ops, lo, hi) / (hi - lo))


def host_ms(ro):
    """Mean ms of a traced unit in which the device was idle: its wall
    time less the time some device op ran inside it."""
    units = unit_spans(ro)
    if not units:
        return None
    idle = [(u.end - u.start) - tracing.union_ns(ro.trace.ops, u.start, u.end) for u in units]
    return sum(idle) / len(idle) / 1e6


def kernel_ms(ro, spans=None):
    """Mean device ms of the kernels of a traced unit; with ``spans``, of
    those launched inside the benchmark's spans of that name."""
    units = unit_spans(ro)
    if not units:
        return None
    if spans is None:
        ops = [op for op in ro.trace.ops if tracing.is_kernel(op) and any(u.start <= op.start <= u.end for u in units)]
    else:
        ops = [op for op in tracing.launched_in(ro.trace, tracing.spans_named(ro.trace, spans)) if tracing.is_kernel(op)]
    if not ops:
        return None
    return sum(op.end - op.start for op in ops) / len(units) / 1e6


def roofline(ro, piece: str, spans=None):
    """Percent of the least time of a unit's ``piece`` of work
    (``work.py``) over the device time of its kernels."""
    ms = kernel_ms(ro, spans)
    return None if not ms else 100.0 * counts.least_ms(ro.work[piece]) / ms


def launches(ro):
    """Mean kernels a traced unit ran on the device."""
    units = unit_spans(ro)
    if not units:
        return None
    n = sum(1 for op in ro.trace.ops if tracing.is_kernel(op) and any(u.start <= op.start <= u.end for u in units))
    return n / len(units)


def mfu(ro, flops_per_unit: float):
    """Percent of the f32 peak that ``flops_per_unit`` a unit over the
    untraced units' wall time comes to."""
    if not ro.units:
        return None
    wall = sum(u.end - u.start for u in ro.units)
    return 100.0 * flops_per_unit * len(ro.units) / wall / counts.F32_OPS_PER_S
