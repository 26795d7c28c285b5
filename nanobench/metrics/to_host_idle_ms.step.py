"""Mean idle ms of a vector-env step given to the span ``ng.to_host``: the
copies of the observations, rewards and dones to numpy."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["to_host"])
