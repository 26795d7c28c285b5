"""Mean idle ms of a DDPG update given to the span ``ng.ddpg.ou``: the OU
gaussians' copy to the card and the eager loop over the day's steps."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["ddpg.ou"])
