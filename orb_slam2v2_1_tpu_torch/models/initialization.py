"""Map bootstrap for depth sensors.

Port of `create_initial_map_depth` from
the JAX package's `models/initialization.py` (StereoInitialization): every
keypoint with depth becomes a map point. The monocular two-view initializer
is not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.topk import set_drop
from .map_state import MapState, append_keyframe, refresh_covis, update_mp_stats
from .tracking import FrameData


def create_initial_map_depth(state: MapState, frame: FrameData, K: torch.Tensor):
    """Returns (state, kf0, n_points)."""
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
