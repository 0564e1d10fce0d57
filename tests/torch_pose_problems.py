"""Motion-only pose problems for the port's `ops.ba.pose_optimization`: the
CPU tests of its plain version (`tests/test_torch_ba.py`) and the card tests of its
kernel (`tests/test_torch_kernels.py`, `kernels.pose_lm`) run the same
cases, made by `kernel_times.pose_inputs` from a seed as CPU tensors.
"""

from __future__ import annotations

import numpy as np

from orb_slam2v2_1_tpu_torch import kernel_times
from orb_slam2v2_1_tpu_torch.ops import ba

LARGE_STEP = (0.4, -0.3, 0.3, 0.2, -0.2, 0.1)


def pose_problem(seed: int, n: int = 1000, stereo_frac: float = 0.3, **kw):
    """(Tcw0, points, obs, K, bf) on the CPU; `kw` as `kernel_times.pose_inputs`."""
    return kernel_times.pose_inputs(np.random.default_rng(seed), "cpu", n, stereo_frac, **kw)


# The card tests' cases: the main path's widths (1000 RGB-D, 2000 KITTI
# slots), monocular only, a mono/stereo mix with more outliers at the
# kernel's most observations (2048, every register slot filled), nothing
# valid (every round runs all 10 iterations, each step rejected), each round
# ending in its first iteration, a far start whose rounds stop at an
# iteration cap of 3 (ITERS), and the motion model's explicit positions.
CASES = {
    "rgbd_1000": lambda: pose_problem(0, 1000),
    "kitti_2000": lambda: pose_problem(1, 2000, stereo_frac=0.8),
    "mono_1000": lambda: pose_problem(2, 1000, stereo_frac=0.0),
    "mixed_2048": lambda: pose_problem(3, 2048, stereo_frac=0.5, outliers=0.2),
    "all_invalid": lambda: pose_problem(5, 1000, invalid=1.1),
    "first_iteration_exit": lambda: pose_problem(6, 1000, outliers=0.0, xi=LARGE_STEP, info_scale=1e-14),
    "capped_far": lambda: pose_problem(7, 1000, xi=LARGE_STEP),
    "vo_points": lambda: pose_problem(8, 1000, vo_layout=True),
}
ITERS = {"capped_far": 3}


def exit_flags(T0, points, obs, K, bf, rounds: int = 4, iters: int = 10):
    """The plain version's result and the exit flags it read, one per
    iteration in order (`sync.host` calls from `ops/ba.py`)."""
    flags = []
    read = ba.sync.host

    def counted(t):
        flags.append(read(t))
        return flags[-1]

    ba.sync.host = counted
    try:
        out = ba.pose_optimization_plain(T0, points, obs, K, bf, rounds, iters)
    finally:
        ba.sync.host = read
    return out, flags


def rounds_of(flags, iters: int = 10):
    """Split the plain version's exit flags into rounds: a round ends on an
    exit or after `iters` iterations."""
    out, cur = [], []
    for f in flags:
        cur.append(f)
        if f or len(cur) == iters:
            out.append(cur)
            cur = []
    assert not cur
    return out
