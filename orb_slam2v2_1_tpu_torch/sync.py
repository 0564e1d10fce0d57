"""Counted device-to-host reads, and the thread role they are counted under.

Every place where the port's control flow needs a value from the device
(LM early exit, the tracking fallbacks, the keyframe decision, the loop
stage's candidates, the global-BA worker's convergence flag) reads it through
`host` or `host_numpy`, so a run can report how many synchronizing transfers
each frame cost. `COUNT["syncs"]` is the total over all threads;
`BY_ROLE` splits it by the role of the thread that read: "tracker" (the
caller's thread, the default), "mapping" and "loop" (the async workers) and
"gba" (the detached global BA). The tracker and the workers read at once,
hence the lock.

`AsyncRead` is the pipelined path's read of a frame's decision vector: a
copy started without waiting, which counts as a read only if the host has to
wait for it.
"""

from __future__ import annotations

import threading

import torch

COUNT = {"syncs": 0}
BY_ROLE: dict = {}
_LOCK = threading.Lock()
_ROLE = threading.local()


def set_role(name: str) -> None:
    """Tag the calling thread for `BY_ROLE` and the kernels' launch counts."""
    _ROLE.name = name


def role() -> str:
    """The calling thread's role; "tracker" unless it was tagged."""
    return getattr(_ROLE, "name", "tracker")


def _count() -> None:
    r = role()
    with _LOCK:
        COUNT["syncs"] += 1
        BY_ROLE[r] = BY_ROLE.get(r, 0) + 1


def host(t: torch.Tensor):
    """`t.tolist()`, counted as one device-to-host transfer."""
    _count()
    return t.tolist()


def host_numpy(*tensors: torch.Tensor) -> list:
    """The tensors as numpy arrays, fetched together and counted as one
    device-to-host round. The arrays are copies, also of CPU tensors: a
    caller may keep or change them without touching the tensors."""
    _count()
    return [t.detach().to("cpu", copy=True).numpy() for t in tensors]


def reset() -> None:
    with _LOCK:
        COUNT["syncs"] = 0
        BY_ROLE.clear()


class AsyncRead:
    """A tensor's copy to the host, started now and read later.

    On the card: a non-blocking copy into pinned host memory on the current
    stream and an event recorded after it; `is_ready()` asks the event. On
    the CPU the copy is made at once and is always ready. `numpy()` waits if
    it must, and only then counts one read."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t.detach().to("cpu", copy=True)
            self._event = None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self):
        if not self.is_ready():
            _count()
            self._event.synchronize()
        return self._host.numpy()
