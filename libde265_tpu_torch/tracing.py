"""Timed sections of the port's hot path, on the profiler's clock.

A span marks one section (the feed pack, the upload, the frame program's
MC, ...)::

    with tracing.span("tde.pack"):
        ...

Spans record only while a ``torch.profiler`` profile records on the
calling thread (``torch._C._autograd._profiler_enabled()``, checked once
per span site), so profiling a request is what turns them on.  Off, a
span site costs that one check and returns the shared no-op context: no
allocation, no clock reading.

On, a span also enters a profiler RecordFunction of its name, which puts
it on the profiler's timeline beside the device's kernels, and keeps a
``Record`` in a bounded in-memory list: its name, thread, start and end in
wall-clock ns (the clock of the profiler's events: ``trace_start_ns`` plus
an event's range), the id of the enclosing span on the same thread and the
request id (the id of the outermost span of the thread, normally
``tde.request``), and the counters noted on it (``span.note(name=value)``,
for example the parse workers of a request).  The RecordFunction comes
from torch's direct binding ``_RecordFunctionFast`` (as in
torch.compile's graphs), not from
``torch.profiler.record_function``, whose operator dispatch costs tens of
us a span in a decode and widens the event by as much on each side.

The profiler records per thread, so a worker thread (the parse thread of
``PipelinedDecoder``) learns from its request's span whether to record:
``req.thread_span(name)`` opens a span of that request on the current
thread, kept in memory only (a span of another thread on the profiler's
timeline would take over the label of the calling thread's idle gaps).

The list keeps the first ``MAX_RECORDS`` spans after a ``clear()``.
``records()``, ``clear()`` and ``summary()`` read it; ``summary()``
gives each span name's count, total ms and self ms (the duration less the
union of its direct children on the same thread).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch

MAX_RECORDS = 1 << 17

_profiler_enabled = torch._C._autograd._profiler_enabled
_RecordFunction = torch._C._profiler._RecordFunctionFast


class Record(NamedTuple):
    name: str
    thread: int          # threading.get_ident() of the recording thread
    start_ns: int        # wall clock (time.time_ns)
    end_ns: int
    id: int
    parent: int | None   # the enclosing span on the same thread
    request: int
    args: dict | None = None   # counters noted on the span (note())


class _Noop:
    """The shared context of a span site while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def thread_span(self, name: str):
        return self

    def note(self, **counters):
        pass


NOOP = _Noop()

_records: list = []
_ids = itertools.count(1)


class _Open(threading.local):
    def __init__(self):
        self.stack = []


_open = _Open()


class _Span:
    __slots__ = ("name", "id", "parent", "request", "start_ns", "args",
                 "_rf")

    def __init__(self, name: str, request: int | None, profiled: bool):
        self.name = name
        self.id = next(_ids)
        self.request = request
        self.args = None
        self._rf = _RecordFunction(name) if profiled else None

    def __enter__(self):
        if self._rf is not None:
            self._rf.__enter__()
        stack = _open.stack
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else None
        if self.request is None:
            self.request = top.request if top is not None else self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if len(_records) < MAX_RECORDS:
            _records.append(Record(self.name, threading.get_ident(),
                                   self.start_ns, end, self.id, self.parent,
                                   self.request, self.args))
        return False

    def note(self, **counters):
        """Keep `counters` (name=value) in this span's Record."""
        self.args = {**(self.args or {}), **counters}

    def thread_span(self, name: str):
        """A span of this span's request on the current thread, in memory
        only (no profiler event)."""
        return _Span(name, self.request, False)


def span(name: str):
    """The context of one section: records while the profiler records on
    this thread, else the shared no-op."""
    if not _profiler_enabled():
        return NOOP
    return _Span(name, None, True)


def records() -> list:
    """The kept Records, in the order their spans ended."""
    return list(_records)


def clear():
    """Forget every kept Record."""
    _records.clear()


def summary() -> dict:
    """{name: {"count", "total_ms", "self_ms"}} over the kept Records; a
    span's self time is its duration less the union of its direct
    children (spans of its own thread), each clipped to it."""
    recs = list(_records)
    kids = defaultdict(list)
    for r in recs:
        if r.parent is not None:
            kids[r.parent].append(r)
    out = {}
    for r in recs:
        dur = r.end_ns - r.start_ns
        covered, last = 0, r.start_ns
        for s, e in sorted((max(c.start_ns, r.start_ns),
                            min(c.end_ns, r.end_ns)) for c in kids[r.id]):
            s = max(s, last)
            if e > s:
                covered += e - s
                last = e
        d = out.setdefault(r.name, {"count": 0, "total_ms": 0.0,
                                    "self_ms": 0.0})
        d["count"] += 1
        d["total_ms"] += dur / 1e6
        d["self_ms"] += (dur - covered) / 1e6
    return out
