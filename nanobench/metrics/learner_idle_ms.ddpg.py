"""Mean idle ms of a DDPG update given to the span ``ng.ddpg.update`` itself:
the learner's own work outside its draws, the OU loop, the replay and the
wrappers (the metrics, the glue)."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["ddpg.update"])
