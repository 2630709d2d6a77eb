"""Host spans around the program's layer entries, recorded by the
benchmark in its own process: each span point of ``benchmark/spans/``
names a module attribute (a function, or a method with ``class``) that is
wrapped for the run, so every call appends (name, start ns, end ns) on the
wall clock the profiler's events use. The program's files are untouched;
only traced runs install the wrappers."""
from __future__ import annotations

import functools
import importlib
import time

from . import spec


class Spans:
    def __init__(self):
        self.items = []          # (name, start_ns, end_ns)
        self._undo = []

    def record(self, name: str, t0: int, t1: int) -> None:
        self.items.append((name, t0, t1))

    def install(self) -> None:
        for name, p in spec.span_points().items():
            mod = importlib.import_module(p["module"])
            owner = getattr(mod, p["class"]) if "class" in p else mod
            fn = getattr(owner, p["attr"])
            setattr(owner, p["attr"], self._wrap(name, fn))
            self._undo.append((owner, p["attr"], fn))

    def remove(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()

    def _wrap(self, name, fn):
        items = self.items

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            t0 = time.time_ns()
            try:
                return fn(*a, **kw)
            finally:
                items.append((name, t0, time.time_ns()))
        return wrapped
