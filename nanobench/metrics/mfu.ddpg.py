"""Percent of the f32 peak in a DDPG update's products (K9's actor forward
each env-step, K10's forwards and backwards of the gradient steps), over
the untraced updates' wall time."""

from nanobench.readers import mfu


def read(ro):
    return mfu(ro, ro.work["collect"]["ops"] + ro.work["sweep"]["ops"])
