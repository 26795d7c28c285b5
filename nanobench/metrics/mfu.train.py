"""Percent of the f32 peak in an update's products (the collection's two
torsos forward, the sweep's forward and backward), over the untraced
updates' wall time."""

from nanobench.readers import mfu


def read(ro):
    return mfu(ro, ro.work["collect"]["ops"] + ro.work["sweep"]["ops"])
