"""Helpers of the per-layer metric readers (``benchmark/metrics/``)."""
from __future__ import annotations


def mean_ms(run, field: str, types) -> float | None:
    """The mean of ``field`` over the coded frames of ``types``, in ms,
    taken outside the traced stretch where the window has such frames
    (the profiler slows the host) and over all of them otherwise."""
    rows = [f for f in run.frames
            if f["type"] in types and f.get(field) is not None]
    rows = [f for f in rows if not f["traced"]] or rows
    if not rows:
        return None
    return 1e3 * sum(f[field] for f in rows) / len(rows)


def kernel_s(run, names) -> float:
    """Device seconds of the kernels whose names contain one of
    ``names``, over the traced stretch."""
    return sum(s for n, s in run.trace["kernels"].items()
               if any(k in n for k in names))
