"""K8's share of its roofline: the least time of a call's Philox blocks and
stats (``work.rbc_days``) over the device time of the call's kernels."""

from nanobench.readers import roofline


def read(ro):
    return roofline(ro, "rbc_days")
