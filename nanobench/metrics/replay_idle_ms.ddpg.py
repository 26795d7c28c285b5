"""Mean idle ms of a DDPG update given to the spans ``ng.ddpg.replay``: the
day's insert into the replay on the card and the gather of the minibatches
(their indices' copy to the card included)."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["ddpg.replay"])
