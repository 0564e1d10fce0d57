"""Counted device-to-host reads.

Every place where the port's control flow needs a value from the device
(LM early exit, the tracking fallbacks, the keyframe decision, the loop
stage's candidates, the global-BA worker's convergence flag) reads it through
`host` or `host_numpy`, so a run can report how many synchronizing transfers
each frame cost. The count is shared by the tracker and the global-BA worker
thread, hence the lock.
"""

from __future__ import annotations

import threading

import torch

COUNT = {"syncs": 0}
_LOCK = threading.Lock()


def _count() -> None:
    with _LOCK:
        COUNT["syncs"] += 1


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
    COUNT["syncs"] = 0
