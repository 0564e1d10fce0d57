"""Map bootstrap: monocular two-view initialization and the single-frame
initialization of depth sensors.

Port of the JAX package's `models/initialization.py`: `Tracking::
MonocularInitialization` + `CreateInitialMapMonocular` (reference
src/Tracking.cc:706-880) and `StereoInitialization` (src/Tracking.cc:652-704).
"""

from __future__ import annotations

import torch

from ..ops import lie, matching, twoview
from ..ops.topk import set_drop
from .map_state import MapState, append_keyframe, refresh_covis, update_mp_stats
from .tracking import FrameData


def match_for_initialization(ref: FrameData, cur: FrameData) -> matching.Matches:
    """SearchForInitialization (src/ORBmatcher.cc:405-520): window 100 px
    around the reference keypoint, level 0 only, ratio 0.9, rotation
    consistency, one-to-one."""
    mask = (
        matching.window_mask(ref.xy, cur.xy, 100.0)
        & (ref.level == 0)[:, None]
        & (cur.level == 0)[None, :]
        & ref.kp_valid[:, None]
        & cur.kp_valid[None, :]
    )
    m = matching.match_nn(ref.desc_pm1, cur.desc_pm1, mask, max_dist=50, nn_ratio=0.9)
    ok = matching.rotation_consistency(ref.angle - cur.angle[m.idx], m.ok)
    return matching.resolve_duplicates(m.idx, m.dist, ok, cur.xy.shape[0])


def create_initial_map_mono(state: MapState, ref: FrameData, cur: FrameData, m_idx: torch.Tensor,
                            res: twoview.TwoViewResult, K: torch.Tensor):
    """The two-keyframe initial map with median-depth normalization
    (CreateInitialMapMonocular, src/Tracking.cc:762-880): every good
    triangulation becomes a map point; `m_idx` maps ref slots to cur slots.
    Returns (state, Tcw_cur, kf0, kf1, n_points)."""
    N = ref.xy.shape[0]
    M = state.max_mp
    good = res.good
    # Median depth -> scale so that the median is 1 (src/Tracking.cc:832-856);
    # nanquantile's 0.5 averages the middle pair as jnp.nanmedian does.
    z = torch.where(good, res.points[:, 2], float("nan"))
    inv_med = 1.0 / torch.clamp(torch.nanquantile(z, 0.5), min=1e-6)
    X = res.points * inv_med
    T1 = lie.make_se3(res.R, res.t * inv_med)

    # The map is empty: points take slots 0..n-1.
    rank = torch.cumsum(good.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(good, rank, M)
    n_new = torch.sum(good, dtype=torch.int32)
    state = state._replace(
        mp_pos=set_drop(state.mp_pos, slot, X),
        mp_valid=set_drop(state.mp_valid, slot, True),
        mp_desc=set_drop(state.mp_desc, slot, cur.desc[m_idx]),
        mp_first_kf=set_drop(state.mp_first_kf, slot, 0),
        n_mp=n_new,
    )
    mp0 = torch.where(good, rank, -1)
    minus = torch.full((N,), -1, dtype=torch.int32, device=good.device)
    mp1 = set_drop(minus, torch.where(good, m_idx, N), mp0)
    eye = torch.eye(4, dtype=torch.float32, device=good.device)
    state, kf0 = append_keyframe(state, eye, ref.frame_id, ref.xy, ref.level, ref.angle, ref.desc,
                                 ref.kp_valid, ref.ur, mp0)
    state, kf1 = append_keyframe(state, T1, cur.frame_id, cur.xy, cur.level, cur.angle, cur.desc,
                                 cur.kp_valid, cur.ur, mp1)
    state = refresh_covis(update_mp_stats(state))
    return state, T1, kf0, kf1, n_new


def create_initial_map_depth(state: MapState, frame: FrameData, K: torch.Tensor):
    """Every keypoint with depth becomes a map point. Returns (state, kf0,
    n_points)."""
    M = state.max_mp
    has_depth = frame.kp_valid & (frame.depth > 0)
    z = torch.clamp(frame.depth, min=1e-6)
    x = (frame.xy[:, 0] - K[2]) * z / K[0]
    y = (frame.xy[:, 1] - K[3]) * z / K[1]
    X = torch.stack([x, y, z], -1)

    rank = torch.cumsum(has_depth.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(has_depth, rank, M)
    state = state._replace(
        mp_pos=set_drop(state.mp_pos, slot, X),
        mp_valid=set_drop(state.mp_valid, slot, True),
        mp_desc=set_drop(state.mp_desc, slot, frame.desc),
        mp_first_kf=set_drop(state.mp_first_kf, slot, 0),
        n_mp=torch.sum(has_depth, dtype=torch.int32),
    )
    mp0 = torch.where(has_depth, rank, -1)
    eye = torch.eye(4, dtype=torch.float32, device=frame.xy.device)
    state, kf0 = append_keyframe(
        state, eye, frame.frame_id, frame.xy, frame.level, frame.angle,
        frame.desc, frame.kp_valid, frame.ur, mp0,
    )
    state = refresh_covis(update_mp_stats(state))
    return state, kf0, state.n_mp
