"""The traced stretch of a window and its reduction in memory.

A traced run profiles one fixed stretch of the window: frames
`from_frame` .. `from_frame + frames` of the first session (the traffic
file's `trace`), with `torch.profiler` recording device activity (CUPTI)
only. The events are reduced in memory as soon as the stretch ends: the
union of kernel, memcpy and memset intervals (busy time), kernels by name,
the device's idle gaps labelled by what the harness's thread was doing and
the kernel that ended the gap. No trace file is written.
"""

from __future__ import annotations

import bisect
import contextlib
import time


@contextlib.contextmanager
def no_span(name):
    yield


def short_name(name: str, n: int = 96) -> str:
    """A kernel's name without its argument list, at most n characters."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, c in enumerate(name):
        depth += c == "<"
        depth -= c == ">"
        if c == "(" and depth == 0:
            name = name[:i]
            break
    return name[:n]


def union(intervals):
    """Merged, sorted [(start, end)] of intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(device_events, t0: int, t1: int, spans, top: int = 10) -> dict:
    """Reduce device events [(name, start_ns, end_ns)] over the stretch
    [t0, t1] (ns) and the host spans [(name, start_ns, end_ns)] of the
    harness's thread."""
    clipped, by_name, n_kernels = [], {}, 0
    for name, s, e in device_events:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        clipped.append((s, e, name))
        n, sec = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, sec + (e - s) * 1e-9)
        if not (name.startswith("Memcpy") or name.startswith("Memset")):
            n_kernels += 1
    merged = union((s, e) for s, e, _ in clipped)
    busy = sum(e - s for s, e in merged) * 1e-9
    starts = sorted((s, name) for s, _, name in clipped)
    gaps, prev = [], t0
    for s, e in merged + [[t1, t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for s, e in gaps[:top]:
        mid = (s + e) // 2
        host = next((n for n, a, b in spans if a <= mid <= b), "between calls")
        nxt = next((n for t, n in _after(starts, e)), "end of stretch")
        labelled.append([f"{host}, then {short_name(nxt, 64)}", (e - s) * 1e-9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "window_s": (t1 - t0) * 1e-9,
        "busy_s": busy,
        "kernels": n_kernels,
        "by_name": {name: list(v) for name, v in by_name.items()},
        "device_ops": [[short_name(name), sec] for name, (_, sec) in ops[:top]],
        "idle_gaps": labelled,
    }


def _after(starts, t):
    i = bisect.bisect_left(starts, (t, ""))
    return starts[i:i + 1]


class Stretch:
    """Profiles frames [from_frame, from_frame + frames) of one session."""

    def __init__(self, spec: dict, session: int = 0):
        self.session, self.first, self.n = session, spec["from_frame"], spec["frames"]
        self.prof = None
        self.spans = []
        self.t0 = self.t1 = None
        self.summary = None

    def at_frame(self, session: int, k: int):
        if session != self.session:
            if self.prof is not None:
                self.stop()
            return
        if k == self.first and self.t0 is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            # Device activity only; a run without a card (the tests) records host ops.
            cuda = torch.cuda.is_available()
            self.prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
            self.prof.start()
            self.t0 = time.time_ns()
            self.offset_ns = self.t0 - time.perf_counter_ns()
        elif k == self.first + self.n and self.prof is not None:
            self.stop()

    @contextlib.contextmanager
    def span(self, name):
        if self.prof is None:
            yield
            return
        a = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, a, time.time_ns()))

    def stop(self):
        if self.prof is None:
            return
        self.t1 = time.time_ns()
        prof, self.prof = self.prof, None
        prof.stop()
        events = []
        for e in prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                s = e.start_ns()
                events.append((e.name(), s, s + e.duration_ns()))
        self.summary = reduce(events, self.t0, self.t1, self.spans)
