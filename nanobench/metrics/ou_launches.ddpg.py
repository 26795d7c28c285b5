"""Mean kernels a DDPG update launches under the span ``ng.ddpg.ou``: the OU
sequence's eager loop, one launch an element-wise op."""

from nanobench.program_spans import launches


def read(ro):
    return launches(ro, ["ddpg.ou"])
