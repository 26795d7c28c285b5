"""K3's share of its roofline: the least time of an update's gradient steps
(``work.sweep``) over the device time of the kernels launched inside the
benchmark's span around the learner's call into ``ops/ppo_sweep.py``."""

from nanobench.readers import roofline


def read(ro):
    return roofline(ro, "sweep", spans="sweep")
