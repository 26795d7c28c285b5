"""Mean idle ms of a PPO update given to the span ``ng.ppo.draw``: the learner's
host draws for the kernel path (the collection seed, the epochs' block
permutations)."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["ppo.draw"])
