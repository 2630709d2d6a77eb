"""How fast the host ran around a run's window: the time a fixed piece of
pure-Python work takes before and after the window, and the process's CPU
time over the window beside its wall. The result line carries them under
``host`` and standard error prints them; no metric reads them. They say
whether a slow run had a slower host: the program's host loop is one
thread that is busy all through the window, so its frames/s follows the
speed of the core it runs on."""
from __future__ import annotations

import os
import resource
import time


def calibrate() -> float:
    """Milliseconds of a fixed piece of pure-Python work (the least of
    three)."""
    best = None
    for _ in range(3):
        t = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += (i * i) % 7
        d = time.perf_counter() - t
        best = d if best is None else min(best, d)
    return 1e3 * best


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


class Window:
    """Host readings over the measured window: ``start`` before it,
    ``stop`` after it."""

    def start(self) -> None:
        self._calib = calibrate()
        self._t, self._cpu = time.perf_counter(), _cpu_s()

    def stop(self) -> dict:
        wall = time.perf_counter() - self._t
        return {"node": os.uname().nodename,
                "process_cpu_s": _cpu_s() - self._cpu, "wall_s": wall,
                "calib_ms": [self._calib, calibrate()]}
