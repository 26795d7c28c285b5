"""Mean idle ms of a PPO update given to the span ``ng.ppo.gae``: the dones and
GAE's eager loop over the day's steps."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["ppo.gae"])
