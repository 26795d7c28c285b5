"""Mean idle ms of a vector-env step given to the span ``ng.engine.step``: the
plain engine's eager step of every env."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["engine.step"])
