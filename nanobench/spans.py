"""The benchmark's own spans around its calls into the program's layers.

:class:`Wrapped` replaces a function that a module of the program calls
with one that runs it inside a ``record_function`` span named ``nb.<span>``
(what a traced run reads) and keeps each result while ``keep`` is set (what
the check reads).  It changes no file of the program: the module attribute
is swapped in this process only.
"""

from __future__ import annotations

from torch.profiler import record_function

from .trace import SPAN_PREFIX


def span(name: str):
    return record_function(SPAN_PREFIX + name)


class Wrapped:
    """``module.attr`` run inside the span ``name``."""

    def __init__(self, module, attr: str, name: str, keep: bool = False):
        self.module, self.attr, self.name = module, attr, name
        self.fn = getattr(module, attr)
        self.keep = keep
        self.seen: list = []
        setattr(module, attr, self)

    def __call__(self, *args, **kwargs):
        with span(self.name):
            out = self.fn(*args, **kwargs)
        if self.keep:
            self.seen.append(out)
        return out
