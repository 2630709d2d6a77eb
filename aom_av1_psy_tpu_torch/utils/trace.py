"""Spans and per-frame counters of the encoders.

``span(name, **attrs)`` times a stage of the program. It always yields a
``Span`` whose ``s`` holds the stage's seconds once the block has left;
with ``into=key`` the seconds are also added to ``key`` of the open
frame's record. ``stages()`` times consecutive spans that share their
boundaries, one clock reading at each, so that they tile the block around
them. ``frame()`` opens that record: every ``encode()`` opens
one, advances the per-process frame id and reads its stage times and
counts (``add``) from it afterwards.

While a ``torch.profiler`` session runs (one read of torch's
profiler-enabled flag per span), each span is also kept as a timeline
record ``(name, start_ns, end_ns, parent, frame, attrs)``: ``parent`` is
the index in ``records()`` of the innermost recorded span that was open
around it (None at the top), ``frame`` the id of the frame it ran in (the
latest begun where none is open), ``start_ns`` / ``end_ns`` read from
``time.time_ns()``, the wall clock that the profiler stamps its CPU and
device events with. So the program's spans lie beside the device's
events of the same session. With no profiler running nothing is kept.
``records()`` lists them and ``clear()`` drops them.

Python's garbage collections are counted per frame: a ``gc.callbacks``
hook, installed once at import, adds each collection that starts and ends
inside an open frame's record to its ``gc_n`` (collections) and ``gc_s``
(their seconds). Collections outside every frame count nowhere.

Spans nest by the order of their blocks on one thread; the encoders run
each frame on one thread.
"""
from __future__ import annotations

import gc
import time

import torch

# True while a torch.profiler session runs (a C call, ~0.1 us)
profiling = torch._C._autograd._profiler_enabled

_records = []          # [name, start_ns, end_ns, parent record, frame, attrs]
_open = []             # the recorded span of each open span (or None)
_frames = []           # the open frames' records, innermost last
_frame_id = 0          # the latest frame begun
_gc_start = None       # (frame, start) of a collection begun inside one


class Span:
    """A span's seconds (``s``) once its block has left."""
    __slots__ = ("s",)

    def __init__(self):
        self.s = None


class span:
    """``with span(name, into=None, **attrs) as sp:`` times the block into
    ``sp.s``; ``into`` names the open frame's entry the seconds are added
    to; under a profiler the block is also kept as a timeline record with
    ``attrs``."""
    __slots__ = ("name", "into", "attrs", "out", "t0", "rec")

    def __init__(self, name: str, into: str | None = None, **attrs):
        self.name, self.into, self.attrs = name, into, attrs
        self.out = Span()

    def __enter__(self) -> Span:
        self.begin()
        return self.out

    def __exit__(self, *exc) -> None:
        self.end(time.perf_counter())

    def begin(self, t: float | None = None, ns: int | None = None) -> None:
        """Open the span; ``t`` / ``ns``: the ``perf_counter`` and
        ``time_ns`` readings it starts at (read now where None)."""
        rec = None
        if profiling():
            rec = [self.name, time.time_ns() if ns is None else ns, None,
                   _open[-1] if _open else None, frame_id(), self.attrs]
            _records.append(rec)
        _open.append(rec)
        self.rec = rec
        self.t0 = time.perf_counter() if t is None else t

    def end(self, t: float, ns: int | None = None) -> None:
        """Close the span at the ``perf_counter`` reading ``t`` (and at
        ``ns`` on the timeline, read now where None)."""
        self.out.s = s = t - self.t0
        if self.rec is not None:
            self.rec[2] = time.time_ns() if ns is None else ns
        _open.pop()
        if self.into is not None and _frames:
            vals = _frames[-1].values
            vals[self.into] = vals.get(self.into, 0.0) + s


class stages:
    """``with stages() as stage:`` times consecutive spans that share their
    boundaries: ``stage(name, into=None, **attrs)`` closes the running one
    and opens the next on the same clock readings (returning its ``Span``),
    and the block's end closes the last. So the stages' seconds add up to
    the block's, to the cost of its own entry and exit."""
    __slots__ = ("cur",)

    def __enter__(self):
        self.cur = None
        return self.stage

    def stage(self, name: str, into: str | None = None, **attrs) -> Span:
        t = time.perf_counter()
        ns = time.time_ns() if profiling() else None
        if self.cur is not None:
            self.cur.end(t, ns)
        self.cur = sp = span(name, into, **attrs)
        sp.begin(t, ns)
        return sp.out

    def __exit__(self, *exc) -> None:
        if self.cur is not None:
            self.cur.end(time.perf_counter())


class Frame:
    """One frame's record: its ``id`` and ``values`` (stage seconds from
    the spans opened with ``into``, counts from ``add``)."""
    __slots__ = ("id", "values")

    def __init__(self, fid: int):
        self.id, self.values = fid, {}

    def pick(self, keys) -> dict:
        """``values`` of ``keys``, 0 where nothing was added."""
        return {k: self.values.get(k, 0) for k in keys}


class frame:
    """``with frame() as rec:``: a new frame id and an empty record, the
    innermost open frame until the block leaves."""
    __slots__ = ("rec",)

    def __enter__(self) -> Frame:
        global _frame_id
        _frame_id += 1
        self.rec = Frame(_frame_id)
        _frames.append(self.rec)
        return self.rec

    def __exit__(self, *exc) -> None:
        _frames.remove(self.rec)


def add(key: str, n) -> None:
    """Add ``n`` to ``key`` of the open frame's record (if one is open)."""
    if _frames:
        vals = _frames[-1].values
        vals[key] = vals.get(key, 0) + n


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a collection that starts inside an open frame
    and ends while that frame is still open adds 1 to its ``gc_n`` and
    its seconds to ``gc_s``."""
    global _gc_start
    if phase == "start":
        _gc_start = (_frames[-1], time.perf_counter()) if _frames else None
    elif _gc_start is not None:
        rec, t0 = _gc_start
        _gc_start = None
        if rec in _frames:
            vals = rec.values
            vals["gc_n"] = vals.get("gc_n", 0) + 1
            vals["gc_s"] = vals.get("gc_s", 0.0) + time.perf_counter() - t0


if _on_gc not in gc.callbacks:
    gc.callbacks.append(_on_gc)


def frame_id() -> int:
    """The id of the innermost open frame, else of the latest begun."""
    return _frames[-1].id if _frames else _frame_id


def records() -> list:
    """The timeline records kept so far, in the order the spans opened:
    ``(name, start_ns, end_ns, parent, frame, attrs)``; ``end_ns`` is None
    for a span still open."""
    index = {id(r): i for i, r in enumerate(_records)}
    return [(r[0], r[1], r[2],
             None if r[3] is None else index.get(id(r[3])), r[4], r[5])
            for r in _records]


def clear() -> None:
    """Drop the timeline records."""
    _records.clear()
