"""K2's share of its roofline: the least time of a collection day
(``work.collect_day``) over the device time of the kernels launched inside
the benchmark's span around the learner's call into ``ops/collect.py``."""

from nanobench.readers import roofline


def read(ro):
    return roofline(ro, "collect", spans="collect")
