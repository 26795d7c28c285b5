"""The program's own spans in a traced run, and the split of each traced
unit's device-idle time and kernels among them.

``smart_nanogrid_gym_torch/utils/profiling.py::span`` records ``ng.<name>``
around the program's layer boundaries while a profiler runs.  They land in
the profiler's trace on the clock of its device records, beside the host's
operators, so :func:`..trace.read` keeps them in ``Trace.host``.

The rule every reader here shares: each idle nanosecond of a traced unit
(:func:`..trace.gaps` over the unit) goes to the innermost ``ng.`` span
covering it, the one that started last and then the shortest; time no
span covers is unspanned (``None``).  The shares and the unspanned time of
a unit add up to its idle time, :func:`..readers.host_ms`, exactly.  Each
device kernel of a unit goes the same way by its host launch time.  A
reader gives None when the run has no trace or none of its spans occur in
the traced units, so a program without the spans reports nothing.
"""

from __future__ import annotations

import bisect
from collections import Counter

from . import trace as tracing
from .readers import unit_spans

PREFIX = "ng."


def program_spans(trace) -> list:
    return [s for s in trace.host if s.name.startswith(PREFIX)]


def innermost(spans) -> list[tuple[int, int, str]]:
    """Disjoint ``(start, end, name)`` pieces of time in order, each named
    by the innermost span covering it; time no span covers has no piece."""
    spans = sorted(spans, key=lambda s: s.start)
    bounds = sorted({t for s in spans for t in (s.start, s.end)})
    pieces, active, i = [], [], 0
    for lo, hi in zip(bounds, bounds[1:]):
        while i < len(spans) and spans[i].start <= lo:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s.end > lo]
        if active:
            inner = max(active, key=lambda s: (s.start, s.start - s.end))
            pieces.append((lo, hi, inner.name))
    return pieces


def _occurring(trace, units, names) -> list:
    """The spans of ``names`` that start inside one of ``units``."""
    return [s for s in program_spans(trace) if s.name in names and any(u.start <= s.start <= u.end for u in units)]


def idle_split(trace, units) -> Counter:
    """Idle ns of ``units`` by the innermost span's name (None: unspanned)."""
    pieces = innermost(program_spans(trace))
    ends = [hi for _, hi, _ in pieces]
    out = Counter()
    for u in units:
        for g0, g1 in tracing.gaps(trace.ops, u.start, u.end):
            covered, k = 0, bisect.bisect_right(ends, g0)
            while k < len(pieces) and pieces[k][0] < g1:
                lo, hi, name = pieces[k]
                part = min(hi, g1) - max(lo, g0)
                out[name] += part
                covered += part
                k += 1
            if covered < g1 - g0:
                out[None] += (g1 - g0) - covered
    return out


def launch_split(trace, units) -> Counter:
    """Device kernels of ``units`` by the innermost span around their host
    launch (None: unspanned, or the profiler linked no launch)."""
    pieces = innermost(program_spans(trace))
    starts = [lo for lo, _, _ in pieces]
    out = Counter()
    for op in trace.ops:
        if not tracing.is_kernel(op) or not any(u.start <= op.start <= u.end for u in units):
            continue
        name = None
        k = bisect.bisect_right(starts, op.launched) - 1
        if op.launched >= 0 and k >= 0 and op.launched < pieces[k][1]:
            name = pieces[k][2]
        out[name] += 1
    return out


def _per(ro, names, per):
    """The traced units and the count to divide by: the units, or with
    ``per`` the occurrences of that span in them; None when the run has no
    trace or no span of ``names`` occurs in it."""
    units = unit_spans(ro)
    if not units:
        return None
    if not _occurring(ro.trace, units, {PREFIX + n for n in names}):
        return None
    n = len(_occurring(ro.trace, units, {PREFIX + per})) if per else len(units)
    return (units, n) if n else None


def idle_ms(ro, names, per: str | None = None):
    """Mean idle ms a traced unit, or with ``per`` an occurrence of the span
    ``ng.<per>``, given to the spans ``ng.<name>`` of ``names``."""
    got = _per(ro, names, per)
    if got is None:
        return None
    units, n = got
    split = idle_split(ro.trace, units)
    return sum(split[PREFIX + name] for name in names) / n / 1e6


def launches(ro, names, per: str | None = None):
    """Mean kernels a traced unit, or with ``per`` an occurrence of the span
    ``ng.<per>``, launched under the spans ``ng.<name>`` of ``names``."""
    got = _per(ro, names, per)
    if got is None:
        return None
    units, n = got
    split = launch_split(ro.trace, units)
    return sum(split[PREFIX + name] for name in names) / n
