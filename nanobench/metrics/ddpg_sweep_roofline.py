"""K10's share of its roofline: the least time of an update's gradient steps
(``work_ddpg.sweep``) over the device time of the kernels launched inside
the benchmark's span around the DDPG learner's call into ``ops/ddpg_sweep.py``."""

from nanobench.readers import roofline


def read(ro):
    return roofline(ro, "sweep", spans="sweep")
