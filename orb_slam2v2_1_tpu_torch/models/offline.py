"""Whole-sequence RGB-D SLAM driver.

Port of the JAX package's `models/offline.py`. The reference runs the
sequence as one `lax.scan` with `lax.cond` branches for keyframe insertion
and capacity culling; here the scan step is a Python loop and those branches
are host branches. Each frame reads its three decision flags (tracked,
insert, blocked) in one device-to-host transfer. With a loop closer the
sequence runs in chunks with a loop-closing round between them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from .. import sync
from ..ops import orb
from . import frontend, initialization, local_mapping
from . import keyframe_database as kdb
from .map_state import MapState, empty_map
from .tracking import FrameData


class ScanCarry(NamedTuple):
    state: MapState
    last: FrameData
    velocity: torch.Tensor  # (4,4)
    have_velocity: bool
    ref_kf: torch.Tensor  # () int64
    last_kf_frame: int
    frame_id: int
    n_live: torch.Tensor  # () live keyframe count
    lost: bool


def _need_kf(stats, carry: ScanCarry, max_frames: int, max_kf: int):
    """NeedNewKeyFrame (RGB-D) on the device: returns (need & room,
    need & ~room)."""
    n_inliers = stats[1]
    ref_matches = stats[3]
    frames_since = carry.frame_id - carry.last_kf_frame
    c2 = (n_inliers < ref_matches * 0.75) & (n_inliers > 15)
    need = c2 | ((stats[4] < 100) & (stats[5] > 70))
    need = need & (frames_since >= 1)
    if frames_since >= max_frames:
        need = torch.ones_like(need)
    room = carry.n_live < max_kf - 2
    return need & room, need & ~room


def _nearest_kf(state: MapState, pose: torch.Tensor) -> torch.Tensor:
    """Live keyframe closest to `pose` in camera center and viewing
    direction (the in-scan relocalization candidate)."""
    R = state.kf_pose[:, :3, :3]
    t = state.kf_pose[:, :3, 3]
    centers = -torch.einsum("kji,kj->ki", R, t)
    c_last = -pose[:3, :3].T @ pose[:3, 3]
    d = torch.linalg.norm(centers - c_last, dim=-1)
    d = d + 2.0 * (1.0 - R[:, 2, :] @ pose[:3, :3][2, :])
    d = torch.where(state.kf_valid, d, float("inf"))
    return torch.argmin(d)


class _CellBox:
    """Single-threaded stand-in for a locked map box in the chunked run:
    the detached GBA service interface (read / mutate) over a plain cell."""

    def __init__(self, state: MapState):
        self.state = state

    def read(self):
        return self.state, 0

    def mutate(self, fn):
        self.state = fn(self.state)
        return self.state


def make_carry0(state: MapState, first: FrameData) -> ScanCarry:
    dev = state.kf_pose.device
    return ScanCarry(
        state=state,
        last=first,
        velocity=torch.eye(4, dtype=torch.float32, device=dev),
        have_velocity=False,
        ref_kf=torch.zeros((), dtype=torch.int64, device=dev),
        last_kf_frame=0,
        frame_id=1,
        n_live=torch.sum(state.kf_valid, dtype=torch.int32),
        lost=False,
    )


def _frame(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def run_sequence_carry(images, depths, carry: ScanCarry, K, dist, bf, depth_limit: float,
                       config: orb.OrbConfig, width: int, height: int, max_frames: int,
                       voc=None):
    """Track a chunk of frames against the evolving map from an explicit
    carry. Returns (carry, poses (F,4,4), ok (F,), T_rel (F,4,4), ref_kfs (F,))."""
    max_kf = carry.state.max_kf
    dev = carry.state.kf_pose.device
    poses, oks, T_rels, refs = [], [], [], []
    for img, depth in zip(images, depths):
        state = carry.state
        last = carry.last
        ref_kf = carry.ref_kf
        if carry.lost:
            # In-scan relocalization: re-anchor on the nearest live keyframe.
            ref_kf = _nearest_kf(state, last.pose)
            last = last._replace(pose=state.kf_pose[ref_kf])
        res = frontend.process_frame_impl(
            state, _frame(img, dev), _frame(depth, dev), last, carry.velocity,
            carry.have_velocity and not carry.lost, ref_kf, K, dist, bf, depth_limit,
            carry.frame_id, config, width, height, voc,
        )
        tracked_d = res.stats[0] > 0
        need_d, blocked_d = _need_kf(res.stats, carry, max_frames, max_kf)
        tracked, need_kf, blocked = sync.host(
            torch.stack([tracked_d, need_d & tracked_d, blocked_d & tracked_d])
        )

        state2, new_ref = res.state, ref_kf
        d_live = torch.zeros((), dtype=torch.int32, device=dev)
        if need_kf:
            state2, new_ref, _, victim, _, _ = frontend.insert_keyframe_fused_impl(
                state2, res.frame, K, bf, depth_limit, voc,
            )
            d_live = torch.where(victim >= 0, 0, 1).to(torch.int32)
        if blocked:
            # Cull-on-full: erase one redundant keyframe so the next
            # insertion finds a free slot.
            state2, victim, _, _ = local_mapping.cull_keyframes(state2, new_ref, force=True)
            d_live = d_live - (victim >= 0).to(torch.int32)

        frame_out = res.frame
        if need_kf:
            # Cull/fuse may have remapped point ids: re-read the keyframe row.
            frame_out = frame_out._replace(mp=state2.kf_mp[new_ref])
        carry = ScanCarry(
            state=state2,
            last=frame_out if tracked else carry.last,
            velocity=res.velocity if tracked else torch.eye(4, dtype=torch.float32, device=dev),
            have_velocity=bool(tracked),
            ref_kf=torch.as_tensor(new_ref, device=dev),
            last_kf_frame=carry.frame_id if need_kf else carry.last_kf_frame,
            frame_id=carry.frame_id + 1,
            n_live=carry.n_live + d_live,
            lost=not tracked,
        )
        poses.append(res.pose)
        oks.append(bool(tracked))
        T_rels.append(res.T_rel)
        refs.append(ref_kf)
    if not poses:
        empty = torch.zeros((0, 4, 4), dtype=torch.float32, device=dev)
        return carry, empty, np.zeros(0, bool), empty, torch.zeros(0, dtype=torch.int64, device=dev)
    return carry, torch.stack(poses), np.asarray(oks, bool), torch.stack(T_rels), torch.stack(refs)


def _loop_round(loop_closer, carry: ScanCarry, last_seq: int):
    """The loop stage after a chunk: one batched add + detect for the
    keyframes the chunk inserted, any accepted closure applied to the live
    map, and the detached GBA started, aborted or merged. Returns (carry,
    last_seq)."""
    state = carry.state
    kf_seq, kf_valid = sync.host_numpy(state.kf_seq, state.kf_valid)
    new = sorted((int(kf_seq[i]), i) for i in range(len(kf_seq)) if kf_valid[i] and kf_seq[i] > last_seq)
    if new:
        last_seq = new[-1][0]
    moved = False
    for slot, cand, S12 in loop_closer.detect_batch(state, [slot for _, slot in new], int(kf_valid.sum())):
        state = loop_closer.apply_closure(state, slot, cand, S12)
        moved = True
    if loop_closer.detached_gba:
        # The solve overlaps the next chunk's tracking; a merged result
        # re-anchors the keyframes born meanwhile.
        box = _CellBox(state)
        moved |= loop_closer.service_gba(box)
        state = box.state
    # The map moved under the motion model after a closure or a merge.
    return carry._replace(state=state, have_velocity=carry.have_velocity and not moved), last_seq


def track_sequence_rgbd(images, depths, cfg, loop_closer=None,
                        chunk: int | None = None, voc=None, device=None):
    """Init on frame 0, track the rest. images/depths are (N,H,W) numpy
    arrays or tensors; tensors stay on their device, numpy frames go to
    `device` (None: the card; raises without one) one at a time. Returns
    (poses (N,4,4) numpy incl. frame 0, ok (N,) numpy, state).

    With `loop_closer` and `chunk`, a loop-closing round runs between chunks
    (BoW update, detection, Sim3, correction and GBA for every keyframe the
    chunk inserted), so the latency of a closure is bounded by the chunk
    length; the loop closer's vocabulary also prunes the reference-keyframe
    and triangulation searches unless `voc` is given."""
    if device is None and torch.is_tensor(images):
        device = images.device
    device = device_mod.resolve(device)
    K = torch.tensor(cfg.K, dtype=torch.float32, device=device)
    dist = torch.tensor(cfg.dist, dtype=torch.float32, device=device)
    bf = float(np.float32(cfg.bf))
    depth_limit = float(np.float32(cfg.bf * cfg.th_depth / cfg.fx))
    ocfg = orb.OrbConfig(
        n_features=cfg.n_features, n_levels=cfg.n_levels, scale=cfg.scale_factor,
        fast_threshold=cfg.fast_threshold, fast_min_threshold=cfg.fast_min_threshold,
    )
    f0 = frontend.build_frame_only(
        _frame(images[0], device), _frame(depths[0], device), K, dist, bf, 0, ocfg,
        cfg.width, cfg.height,
    )
    state = empty_map(cfg.max_keyframes, cfg.max_map_points, cfg.n_features, device=device)
    state, _, _ = initialization.create_initial_map_depth(state, f0, K)
    f0 = f0._replace(mp=state.kf_mp[0])
    carry = make_carry0(state, f0)
    if voc is None and loop_closer is not None:
        voc = loop_closer.vocab
    scan_args = (K, dist, bf, depth_limit, ocfg, cfg.width, cfg.height, int(cfg.fps), voc)
    loop_rounds = loop_closer is not None and chunk is not None
    if loop_rounds:
        if loop_closer.kf_counter == 0:
            # Register the initial keyframe with the BoW database.
            loop_closer.db = kdb.add_keyframe(loop_closer.db, loop_closer.vocab, 0,
                                              state.kf_desc[0], state.kf_kp_valid[0])
            loop_closer.kf_counter = 1
        last_seq = sync.host(torch.amax(torch.where(state.kf_valid, state.kf_seq, -1)))

    n = images.shape[0]
    step = n if chunk is None else chunk
    pieces_p, pieces_ok = [], []
    s = 1
    while s < n:
        e = min(s + step, n)
        carry, poses_c, ok_c, _, _ = run_sequence_carry(images[s:e], depths[s:e], carry, *scan_args)
        pieces_p.append(poses_c.cpu().numpy())
        pieces_ok.append(ok_c)
        if loop_rounds:
            carry, last_seq = _loop_round(loop_closer, carry, last_seq)
        s = e
    if loop_rounds and loop_closer.detached_gba:
        box = _CellBox(carry.state)
        loop_closer.service_gba(box)
        loop_closer.finalize_gba(box)
        carry = carry._replace(state=box.state)
    poses = np.concatenate([np.eye(4, dtype=np.float32)[None], *pieces_p])
    ok = np.concatenate([np.ones(1, bool), *pieces_ok])
    return poses, ok, carry.state
