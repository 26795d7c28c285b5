"""Mean idle ms of an evaluation call given to the span ``ng.guard``: the param
guard's copy of the baked params to the host and its comparisons."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["guard"])
