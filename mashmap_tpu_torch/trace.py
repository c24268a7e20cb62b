"""Spans of the program's phases, on one clock.

A phase is timed where its work happens: ``span(name)`` around a block
(or as a decorator); ``clock(prefix, sink)``, whose ``mark(label)`` ends
the phase begun at the previous mark and hands its seconds to ``sink``
(``Mapper.phase_s`` and ``index.builder.GROUP_PHASE_S`` are such sinks,
with their DEBUG lines); ``add(name, seconds)``, a total alone.

``totals[name]`` = (seconds, count) of spans and adds is always kept;
each ``map_files`` call (a job, ``job``) leaves its own in ``JOBS``.
Inside ``recording()`` every span and clock phase is also kept as
(name, parent, thread, start ns, end ns, job, batch): stamped on
``time.perf_counter_ns``, exported on ``time.time_ns`` through one
offset read when recording starts, so a wall-clock step moves no span.
While a torch.profiler is active a recorded span also opens
``torch.profiler.record_function(name)``, which puts it in the
profiler's trace beside the device's work.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time

totals: dict = {}
JOBS: collections.deque = collections.deque(maxlen=64)
_lock = threading.Lock()
_job = 0
_rec = None
_END = object()


def add(name: str, seconds: float, count: int = 1) -> None:
    with _lock:
        s, n = totals.get(name, (0.0, 0))
        totals[name] = (s + seconds, n + count)


def _snapshot() -> dict:
    with _lock:
        return dict(totals)


def _since(before: dict) -> dict:
    """What ``totals`` gained since ``before`` (a ``_snapshot``)."""
    out = {}
    for k, (s, n) in _snapshot().items():
        s0, n0 = before.get(k, (0.0, 0))
        if n != n0:
            out[k] = (s - s0, n - n0)
    return out


class Record:
    """The spans and totals of one ``recording()``."""

    def __init__(self):
        self.offset = time.time_ns() - time.perf_counter_ns()
        self.main = threading.main_thread().name
        self.totals: dict = {}
        self._before = _snapshot()
        self._raw: list = []

    def keep(self, name, t0, t1, batch):
        self._raw.append((name, threading.current_thread().name, t0, t1,
                          _job, batch))

    def spans(self) -> list:
        """(name, parent, thread, start ns, end ns, job, batch) by start,
        on ``time.time_ns``; ``parent`` is the index of the innermost
        span of the same thread whose interval holds this one, or None."""
        out, stacks = [], {}
        for name, th, t0, t1, job, batch in sorted(
                self._raw, key=lambda r: (r[2], -r[3])):
            stack = stacks.setdefault(th, [])
            while stack and out[stack[-1]][4] < t1 + self.offset:
                stack.pop()
            out.append((name, stack[-1] if stack else None, th,
                        t0 + self.offset, t1 + self.offset, job, batch))
            stack.append(len(out) - 1)
        return out


@contextlib.contextmanager
def recording():
    """Keep every span and clock phase while the block runs; yields the
    ``Record``, whose ``totals`` are filled when the block ends."""
    global _rec
    rec = _rec = Record()
    try:
        yield rec
    finally:
        _rec = None
        rec.totals = _since(rec._before)


def _annotation(name):
    from torch.autograd import profiler
    return (profiler.record_function(name) if profiler._is_profiler_enabled
            else contextlib.nullcontext())


@contextlib.contextmanager
def span(name: str):
    rec = _rec
    with _annotation(name) if rec is not None else contextlib.nullcontext():
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            add(name, (t1 - t0) / 1e9)
            if rec is not None:
                rec.keep(name, t0, t1, None)


def clock(prefix: str, sink, batch=None):
    """mark(label): the seconds since the previous mark (or since this
    call) go to ``sink(label, seconds)``; while recording, the interval
    is kept as a span ``prefix + label`` of ``batch``, unless the mark
    says ``keep=False`` (the phase is a ``span`` of its own already)."""
    t = [time.perf_counter_ns()]

    def mark(label, keep=True):
        now = time.perf_counter_ns()
        sink(label, (now - t[0]) / 1e9)
        rec = _rec
        if keep and rec is not None:
            rec.keep(prefix + label, t[0], now, batch)
        t[0] = now
    return mark


def each(name: str, items):
    """The elements of ``items``; each wait for the next is a span."""
    it = iter(items)
    while True:
        with span(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item


def job(fn):
    """``fn``'s calls are jobs: each takes the next ordinal, which its
    spans carry, and leaves (ordinal, its totals) in ``JOBS``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        global _job
        _job += 1
        ordinal, before = _job, _snapshot()
        try:
            return fn(*args, **kwargs)
        finally:
            JOBS.append((ordinal, _since(before)))
    return run
