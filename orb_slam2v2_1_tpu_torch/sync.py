"""Counted device-to-host reads.

Every place where the port's control flow needs a value from the device
(LM early exit, the tracking fallbacks, the keyframe decision) reads it
through `host`, so a run can report how many synchronizing transfers each
frame cost.
"""

from __future__ import annotations

import torch

COUNT = {"syncs": 0}


def host(t: torch.Tensor):
    """`t.tolist()`, counted as one device-to-host transfer."""
    COUNT["syncs"] += 1
    return t.tolist()


def reset() -> None:
    COUNT["syncs"] = 0
