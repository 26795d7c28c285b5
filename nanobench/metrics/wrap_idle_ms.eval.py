"""Mean idle ms of an evaluation call given to the entry and the wrappers:
the spans ``ng.evaluate``, ``ng.rbc_days``, ``ng.policy_days`` (the traces, the
weight packing, the library) and ``ng.launch`` (the C call)."""

from nanobench.program_spans import idle_ms


def read(ro):
    return idle_ms(ro, ["evaluate", "rbc_days", "policy_days", "launch"])
