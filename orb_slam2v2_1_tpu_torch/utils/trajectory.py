"""Trajectory bookkeeping + TUM/KITTI export.

A copy of the JAX package's `utils/trajectory.py` (numpy; importing the
reference's module would load JAX). Per-frame poses are stored relative to
their reference keyframe, so later keyframe optimization (local BA, loop
closure, global BA) moves the whole trajectory when it is saved: the
reference's `mlRelativeFramePoses` chain (src/Tracking.cc:630-647).
A relative pose may be held as a tensor until it is read: `_materialize`
fetches every such pose in one counted transfer.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .. import sync
from ..ops import lie


@dataclasses.dataclass
class TrajectoryEntry:
    timestamp: float
    ref_kf: int
    T_rel: np.ndarray  # (4,4) Tcw_frame @ Twc_refkf; may be a tensor until read
    lost: bool = False
    # Redirect corrections accumulated while T_rel is still a tensor
    # (right-multiplied when it is read).
    post: np.ndarray | None = None


class Trajectory:
    def __init__(self):
        self.entries: list[TrajectoryEntry] = []

    def append(self, timestamp: float, ref_kf: int, Tcw_frame, Tcw_ref, lost=False):
        Tcw_frame = np.asarray(Tcw_frame, np.float64)
        Tcw_ref = np.asarray(Tcw_ref, np.float64)
        T_rel = Tcw_frame @ np.linalg.inv(Tcw_ref)
        self.entries.append(TrajectoryEntry(timestamp, ref_kf, T_rel, lost))

    def append_rel(self, timestamp: float, ref_kf: int, T_rel, lost=False):
        """Record a relative pose, numpy or a tensor read later."""
        self.entries.append(TrajectoryEntry(timestamp, ref_kf, T_rel, lost))

    def redirect_kf(self, victim: int, parent: int, T_victim_wrt_parent):
        """Rewrite entries referencing an erased keyframe onto its spanning-
        tree parent: T_rel' = T_rel @ (Tcw_victim @ Twc_parent), applied at
        cull time so victim slots can be reused (src/System.cc:610-629)."""
        T = np.asarray(T_victim_wrt_parent, np.float64)
        for e in self.entries:
            if e.ref_kf == victim:
                if isinstance(e.T_rel, np.ndarray):
                    e.T_rel = e.T_rel @ T
                else:
                    e.post = T if e.post is None else e.post @ T
                e.ref_kf = parent

    def _materialize(self):
        """Fetch all tensor-held relative poses in one transfer and fold in
        any redirect corrections accumulated meanwhile."""
        lazy = [i for i, e in enumerate(self.entries) if not isinstance(e.T_rel, np.ndarray)]
        if lazy:
            (vals,) = sync.host_numpy(torch.stack([self.entries[i].T_rel for i in lazy]))
            for i, v in zip(lazy, vals):
                self.entries[i].T_rel = np.asarray(v, np.float64)
        for e in self.entries:
            if e.post is not None:
                e.T_rel = e.T_rel @ e.post
                e.post = None

    def absolute_poses(self, kf_poses: np.ndarray) -> list[tuple[float, np.ndarray]]:
        """Resolve to absolute Twc using the current (optimized) keyframe
        poses. Returns [(t, Twc)] skipping lost frames."""
        self._materialize()
        out = []
        for e in self.entries:
            if e.lost:
                continue
            Tcw = e.T_rel @ np.asarray(kf_poses[e.ref_kf], np.float64)
            out.append((e.timestamp, np.linalg.inv(Tcw)))
        return out

    def save_tum(self, path: str | Path, kf_poses: np.ndarray):
        """`timestamp tx ty tz qx qy qz qw` of the camera in world frame."""
        lines = []
        for t, Twc in self.absolute_poses(kf_poses):
            q = lie.rot_to_quat(torch.from_numpy(Twc[:3, :3].astype(np.float32))).numpy()
            tr = Twc[:3, 3]
            lines.append(
                f"{t:.6f} {tr[0]:.7f} {tr[1]:.7f} {tr[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}"
            )
        Path(path).write_text("\n".join(lines) + "\n")

    def save_kitti(self, path: str | Path, kf_poses: np.ndarray):
        """Row-major 3x4 Twc per line (KITTI odometry format)."""
        lines = []
        for _, Twc in self.absolute_poses(kf_poses):
            r = Twc[:3, :4].reshape(-1)
            lines.append(" ".join(f"{v:.9e}" for v in r))
        Path(path).write_text("\n".join(lines) + "\n")


def ate_rmse(est: list[tuple[float, np.ndarray]], gt: dict[float, np.ndarray],
             max_dt: float = 0.02, align_scale: bool = True) -> float:
    """Absolute trajectory error after Horn/Umeyama alignment (the standard
    TUM evaluation; scale-aligned for monocular)."""
    gt_times = np.array(sorted(gt.keys()))
    P, Q = [], []
    for t, Twc in est:
        i = np.searchsorted(gt_times, t)
        for j in (i - 1, i):
            if 0 <= j < len(gt_times) and abs(gt_times[j] - t) <= max_dt:
                P.append(Twc[:3, 3])
                Q.append(gt[gt_times[j]][:3, 3])
                break
    if len(P) < 3:
        return float("inf")
    P = np.asarray(P).T  # (3, n) estimated
    Q = np.asarray(Q).T  # (3, n) ground truth
    mu_p = P.mean(1, keepdims=True)
    mu_q = Q.mean(1, keepdims=True)
    Pc, Qc = P - mu_p, Q - mu_q
    W = Qc @ Pc.T
    U, d, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if align_scale:
        s = np.trace(np.diag(d) @ S) / max((Pc * Pc).sum(), 1e-12)
    else:
        s = 1.0
    t = mu_q - s * R @ mu_p
    err = s * R @ P + t - Q
    return float(np.sqrt((err * err).sum(0).mean()))
