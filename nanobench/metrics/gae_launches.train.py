"""Mean kernels a PPO update launches under the span ``ng.ppo.gae``: the dones
and GAE's eager loop, one launch an element-wise op."""

from nanobench.program_spans import launches


def read(ro):
    return launches(ro, ["ppo.gae"])
