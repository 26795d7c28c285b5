"""Mean idle ms of a DDPG update given to the kernel wrappers: the spans
``ng.collect`` (K9's: the weight packing, the checks), ``ng.sweep`` (K10's:
the flattening, the concatenated inputs) and ``ng.launch`` (the C call)."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["collect", "sweep", "launch"])
