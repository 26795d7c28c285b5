"""Mean idle ms of a PPO update given to the kernel wrappers: the spans
``ng.collect`` (K2's), ``ng.sweep`` (K3's: the host checks of the permutation,
the flattening, the minibatch stats) and ``ng.launch`` (the C call)."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["collect", "sweep", "launch"])
