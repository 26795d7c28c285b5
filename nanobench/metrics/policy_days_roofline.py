"""K6's share of its roofline: the least time of a call's actor products,
Philox blocks and stats (``work.policy_days``) over the device time of the
call's kernels."""

from nanobench.readers import roofline


def read(ro):
    return roofline(ro, "policy_days")
