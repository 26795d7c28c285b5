"""Mean idle ms of a DDPG update given to the span ``ng.ddpg.draw``: the
learner's host draws (the collection seed, the OU gaussians, the minibatch
indices)."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["ddpg.draw"])
