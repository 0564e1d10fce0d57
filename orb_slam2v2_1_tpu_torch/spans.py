"""Spans and wait clocks: where the port's host time goes, on one clock.

A span is one stretch of host work on one thread. It records its name, the
thread's role (`sync.role()`), a key (the frame id on the tracker, the
keyframe id on the workers; a span opened without a key takes its
parent's), its parent (the name of the span open on the same thread when it
opened, or None) and its start and end in `time.perf_counter_ns()`. A trace
that notes `time.time_ns() - time.perf_counter_ns()` once places every span
on its own timeline, the device trace of `torch.profiler` included.

A `Recorder` keeps every span in one bounded ring and appends the span's
length in ms to the deque of its name in `series`, where the name has one
(the `SlamSystem`'s `_metrics`). A span costs two clock reads and two
appends: it reads nothing from the device, synchronizes nothing and makes
no tensor.

The wait clock: `sync`'s counted reads (only where they wait) and the map's
structural lock (only where it is held) report how long the calling thread
was blocked (`waited`). That adds to the thread's running totals and, on a
thread bound to a recorder (`bind`), goes into the ring as a span
`read_wait` or `map_wait` under the span open there. `Recorder.call` spans
one entry-point call and records, besides, one sample of each total's growth
during the call: a counter, in the ring with the call's start and end and
the milliseconds waited as its `ms`.
"""

from __future__ import annotations

import threading
from collections import deque
from time import perf_counter_ns
from typing import NamedTuple

from . import sync

# The ring's length: every span of about a thousand tracked frames.
RING = 1 << 15
READ, MAP = 0, 1
WAIT_NAMES = ("read_wait", "map_wait")


class Span(NamedTuple):
    name: str
    role: str
    key: int | None
    parent: str | None
    start_ns: int
    end_ns: int
    ms: float  # the span's length; a counter's sample


class _Thread(threading.local):
    def __init__(self):
        self.rec = None  # the recorder bound to this thread
        self.open = []  # (name, key) of the spans open on this thread, innermost last
        self.waited = [0, 0]  # ns this thread was blocked in reads and on the map


_T = _Thread()


class _Open:
    """One span: timed from `__enter__` to `__exit__`; `key` may be set
    inside it (a keyframe's id once it is known)."""

    __slots__ = ("rec", "name", "key", "parent", "stack", "t0", "t1")

    def __init__(self, rec: Recorder, name: str, key):
        self.rec, self.name, self.key = rec, name, key

    def __enter__(self):
        self.stack = stack = _T.open
        if stack:
            self.parent, key = stack[-1]
            if self.key is None:
                self.key = key
        else:
            self.parent = None
        stack.append((self.name, self.key))
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = t1 = perf_counter_ns()
        self.stack.pop()
        self.rec.add(self.name, self.key, self.parent, self.t0, t1, (t1 - self.t0) * 1e-6)
        return False


class _Call(_Open):
    """A span of one entry-point call, with the recorder bound to the thread
    inside it and one sample each of the thread's read and map waits."""

    __slots__ = ("counters", "w0", "prev")

    def __enter__(self):
        t = _T
        self.prev, t.rec = t.rec, self.rec
        self.w0 = tuple(t.waited)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        t = _T
        t.rec = self.prev
        for name, now, before in zip(self.counters, t.waited, self.w0):
            self.rec.add(name, self.key, self.name, self.t0, self.t1, (now - before) * 1e-6)
        return False


class _Nothing:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOTHING = _Nothing()


class Recorder:
    """One ring of spans and the deques of the names that keep their
    lengths. `ring`: a ring to share (a detached solve's recorder writes
    into its system's)."""

    def __init__(self, ring: deque | None = None):
        self.ring = deque(maxlen=RING) if ring is None else ring
        self.series: dict[str, deque] = {}

    def keep(self, name: str, maxlen: int) -> deque:
        """The deque of `name`'s samples in ms (made on the first call)."""
        return self.series.setdefault(name, deque(maxlen=maxlen))

    def span(self, name: str, key=None) -> _Open:
        return _Open(self, name, key)

    def call(self, name: str, key, read_counter: str, map_counter: str) -> _Call:
        """`span(name, key)` around one call, bound to the calling thread;
        at its end one sample each of `read_counter` and `map_counter`, the
        ms the thread waited in reads and on the map during the call."""
        c = _Call(self, name, key)
        c.counters = (read_counter, map_counter)
        return c

    def add(self, name: str, key, parent, start_ns: int, end_ns: int, ms: float) -> None:
        self.ring.append((name, sync.role(), key, parent, start_ns, end_ns, ms))
        s = self.series.get(name)
        if s is not None:
            s.append(ms)

    def spans(self, since_ns: int | None = None) -> list[Span]:
        """The ring, oldest first (in the order the spans ended); with
        `since_ns`, the spans that ended at or after it."""
        ring = list(self.ring)  # one copy under the GIL: the workers append
        return [Span(*r) for r in ring if since_ns is None or r[5] >= since_ns]


class bind:
    """Bind a recorder to the calling thread (`span` and the wait clock
    record into it), and unbind on exit."""

    __slots__ = ("rec", "prev")

    def __init__(self, rec: Recorder | None):
        self.rec = rec

    def __enter__(self):
        t = _T
        self.prev, t.rec = t.rec, self.rec
        return self.rec

    def __exit__(self, *exc):
        _T.rec = self.prev
        return False


def span(name: str, key=None):
    """A span into the recorder bound to the calling thread; nothing where
    none is bound (`models/offline.py`, warm-up, a library call)."""
    rec = _T.rec
    return _NOTHING if rec is None else _Open(rec, name, key)


def waited(kind: int, start_ns: int) -> None:
    """The calling thread was blocked from `start_ns` until now: in a read
    (`READ`) or on the map (`MAP`)."""
    t1 = perf_counter_ns()
    t = _T
    t.waited[kind] += t1 - start_ns
    rec = t.rec
    if rec is not None:
        stack = t.open
        parent, key = stack[-1] if stack else (None, None)
        rec.add(WAIT_NAMES[kind], key, parent, start_ns, t1, (t1 - start_ns) * 1e-6)
