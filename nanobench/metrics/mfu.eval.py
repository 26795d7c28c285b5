"""Percent of the f32 peak in the actor's forward products of the
evaluation calls, over the untraced calls' wall time."""

from nanobench.readers import mfu


def read(ro):
    return mfu(ro, ro.work["policy_days"]["ops"])
