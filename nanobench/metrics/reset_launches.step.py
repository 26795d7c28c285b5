"""Mean kernels a day-end reset launches: those under the span
``ng.vecenv.reset`` and the span ``ng.generate`` inside it."""

from nanobench.program_spans import launches


def read(ro):
    return launches(ro, ["vecenv.reset", "generate"], per="vecenv.reset")
