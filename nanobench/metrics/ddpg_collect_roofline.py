"""K9 seeded's share of its roofline: the least time of a collection day
(``work_ddpg.collect_day_seeded``) over the device time of the kernels
launched inside the benchmark's span around the DDPG learner's call into
``ops/ddpg_collect.py``."""

from nanobench.readers import roofline


def read(ro):
    return roofline(ro, "collect", spans="collect")
