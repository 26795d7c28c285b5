"""Mean idle ms of a PPO update given to the span ``ng.ppo.update`` itself:
the learner's own work outside its draws, GAE and the wrappers (the layout,
the metrics, the glue)."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["ppo.update"])
