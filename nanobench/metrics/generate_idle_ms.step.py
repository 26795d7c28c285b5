"""Mean idle ms of a day-end reset (a span ``ng.vecenv.reset``) given to the
span ``ng.generate``: the plain generation of every env's fresh day."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["generate"], per="vecenv.reset")
