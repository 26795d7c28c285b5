"""Percent of the f32 peak in the actor's forward over every env of a
step, over the untraced steps' wall time (the client's actor and the env)."""

from nanobench.readers import mfu


def read(ro):
    return mfu(ro, ro.work["actor_flops_per_step"])
