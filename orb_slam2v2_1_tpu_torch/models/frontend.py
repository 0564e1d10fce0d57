"""Per-frame program: frame construction, tracking, keyframe insertion.

Port of the JAX package's `models/frontend.py` for RGB-D, stereo and
monocular frames, with the split keyframe pipeline of the async runtime
(`append_keyframe_only` on the tracker, `mapping_pipeline` on the mapping
worker, `mapping_pipeline_dist` where the window BA is sharded over a device
mesh). The reference fuses a frame into one device program with `lax.cond` branches;
here the two tracking fallbacks (wide-window retry, reference-keyframe
search) are host branches, each decided by one counted device read
(`sync.host`).

Spans (`spans.span`, recorded where the calling thread has a recorder bound,
keyed as the span around them): `frame_build` (a frame's construction),
`tracking` (`track_frame_impl`) and `local_ba` (the window BA of a mapping
round).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import spans, sync
from ..ops import lie, orb, stereo, undistort
from . import local_mapping, tracking
from .map_state import MapState, append_keyframe, mp_observation_count, refresh_covis, update_mp_stats_window
from .tracking import FrameData


class FrameResult(NamedTuple):
    state: MapState
    frame: FrameData
    pose: torch.Tensor  # (4,4)
    T_rel: torch.Tensor  # (4,4) Tcw_frame @ Twc_refkf
    velocity: torch.Tensor  # (4,4)
    stats: torch.Tensor  # (9,) f32: [tracked_ok, n_inliers, n_matches, ref_matches,
    #                 tracked_close, untracked_close, used_fallback, n_assoc, stage1_inliers]


def _build_frame(img, depth, K, dist, bf, config: orb.OrbConfig,
                 frame_id, width: int, height: int) -> FrameData:
    """Frame construction (Frame ctor analog) from an image and its depth;
    `depth=None` (monocular) leaves every keypoint's depth and ur at -1."""
    with spans.span("frame_build"):
        feats = orb.extract_orb(img, config)
        xy_u = undistort.undistort_points(feats.xy, K, dist)
        n = feats.xy.shape[0]
        dev = img.device
        if depth is None:
            d = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
            ur = d.clone()
        else:
            xi = torch.clamp(feats.xy[:, 0].to(torch.int32), 1, width - 2).long()
            yi = torch.clamp(feats.xy[:, 1].to(torch.int32), 1, height - 2).long()
            # 3x3 depth-edge filter: reject depth at discontinuities.
            patch = torch.stack([depth[yi + dy, xi + dx] for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=-1)
            d = depth[yi, xi]
            pmin = torch.amin(patch, -1)
            spread = torch.amax(patch, -1) - pmin
            edge_ok = (pmin > 0) & (spread < 0.1 * torch.clamp(d, min=1e-6))
            d = torch.where(edge_ok, d, -1.0)
            ur = torch.where(d > 0, xy_u[:, 0] - bf / torch.clamp(d, min=1e-6), -1.0)
        return FrameData(
            xy=xy_u, level=feats.level, angle=feats.angle, desc=feats.desc,
            desc_pm1=feats.desc_pm1, kp_valid=feats.valid, ur=ur, depth=d,
            pose=torch.eye(4, dtype=torch.float32, device=dev),
            mp=torch.full((n,), -1, dtype=torch.int32, device=dev), frame_id=frame_id,
        )


def build_frame_only(img, depth, K, dist, bf, frame_id, config: orb.OrbConfig,
                     width: int, height: int) -> FrameData:
    """Frame construction alone (initialization phase)."""
    return _build_frame(img, depth, K, dist, bf, config, frame_id, width, height)


def build_frame_stereo(img_left, img_right, K, dist, bf, frame_id, config: orb.OrbConfig) -> FrameData:
    """Stereo frame from a rectified pair (the Frame stereo constructor,
    src/Frame.cc:61-117): ORB on both images (two `fast_score_nms`
    launches), row matching with min_z = bf / fx, SAD subpixel disparity,
    undistortion."""
    with spans.span("frame_build"):
        fl = orb.extract_orb(img_left, config)
        fr = orb.extract_orb(img_right, config)
        ur, _, ok = stereo.match_stereo(
            fl.xy, fl.level, fl.desc_pm1, fl.valid, fr.xy, fr.level, fr.desc_pm1, fr.valid, bf, K[0], bf / K[0],
        )
        ur, depth = stereo.sad_subpixel_refine(img_left, img_right, fl.xy, ur, ok, bf)
        n = fl.xy.shape[0]
        dev = img_left.device
        return FrameData(
            xy=undistort.undistort_points(fl.xy, K, dist), level=fl.level, angle=fl.angle, desc=fl.desc,
            desc_pm1=fl.desc_pm1, kp_valid=fl.valid, ur=ur, depth=depth,
            pose=torch.eye(4, dtype=torch.float32, device=dev),
            mp=torch.full((n,), -1, dtype=torch.int32, device=dev), frame_id=frame_id,
        )


def process_frame_impl(state: MapState, img, depth, last: FrameData, velocity,
                       have_velocity: bool, ref_kf, K, dist, bf, depth_limit: float,
                       frame_id, config: orb.OrbConfig, width: int, height: int,
                       voc=None, vo_points: bool = False, mono: bool = False) -> FrameResult:
    cur = _build_frame(img, depth, K, dist, bf, config, frame_id, width, height)
    return track_frame_impl(state, cur, last, velocity, have_velocity, ref_kf, K, bf,
                            depth_limit, width, height, voc, vo_points, mono)


def track_frame_impl(state: MapState, cur: FrameData, last: FrameData, velocity,
                     have_velocity: bool, ref_kf, K, bf, depth_limit: float, width: int,
                     height: int, voc=None, vo_points: bool = False, mono: bool = False) -> FrameResult:
    with spans.span("tracking"):
        # --- stage 1: motion model (with wide retry) or reference-KF fallback ---
        r1 = 15.0 if mono else 7.0  # the motion model's search radius in pixels
        T_pred = lie.orthonormalize(velocity @ last.pose)
        use_fallback = True
        if have_velocity:
            # Without a velocity the reference still runs the motion model, then
            # replaces its result by the fallback's: skipping it changes nothing.
            Tcw, cur_mp, st1 = tracking.track_motion_model(state, cur, last, T_pred, K, bf, r1, vo_points)
            if sync.host(st1.n_inliers < 10):
                Tcw, cur_mp, st1 = tracking.track_motion_model(state, cur, last, T_pred, K, bf, r1 * 2.0, vo_points)
            use_fallback = sync.host(st1.n_inliers < 10)
        if use_fallback:
            Tcw, cur_mp, st1 = tracking.track_reference_keyframe(state, cur, ref_kf, last.pose, K, bf, voc)
        stage1_ok = st1.n_inliers >= 10

        # --- stage 2: local map ---
        cur1 = cur._replace(pose=Tcw, mp=cur_mp)
        state, Tcw2, cur_mp2, st2 = tracking.track_local_map(state, cur1, Tcw, K, bf, 0.5, (width, height))
        tracked_ok = stage1_ok & (st2.n_inliers >= 30)
        cur2 = cur._replace(pose=Tcw2, mp=torch.where(tracked_ok, cur_mp2, cur.mp))

        # --- keyframe-policy statistics (NeedNewKeyFrame inputs) ---
        obs = mp_observation_count(state)
        min_obs = torch.where(state.n_kf > 2, 3, 2)
        ref_mp = state.kf_mp[ref_kf]
        ref_matches = torch.sum(
            (ref_mp >= 0) & state.kf_kp_valid[ref_kf] & (obs[torch.clamp(ref_mp, min=0).long()] >= min_obs)
        )
        close = cur2.kp_valid & (cur2.depth > 0) & (cur2.depth < depth_limit)
        has_mp = cur2.mp >= 0

        T_rel = Tcw2 @ lie.se3_inverse(state.kf_pose[ref_kf])
        new_velocity = lie.orthonormalize(Tcw2 @ lie.se3_inverse(last.pose))
        f32 = torch.float32
        stats = torch.stack([
            tracked_ok.to(f32),
            st2.n_inliers.to(f32),
            st1.n_matches.to(f32),
            ref_matches.to(f32),
            torch.sum(close & has_mp).to(f32),
            torch.sum(close & ~has_mp).to(f32),
            torch.tensor(float(use_fallback), dtype=f32, device=Tcw2.device),
            torch.sum(has_mp).to(f32),
            st1.n_inliers.to(f32),
        ])
        return FrameResult(state=state, frame=cur2, pose=Tcw2, T_rel=T_rel, velocity=new_velocity, stats=stats)


def _append_keyframe_body(state: MapState, frame: FrameData, K, bf, depth_limit: float):
    state, kf_id = append_keyframe(
        state, frame.pose, frame.frame_id, frame.xy, frame.level, frame.angle,
        frame.desc, frame.kp_valid, frame.ur, frame.mp,
    )
    if depth_limit > 0:
        state = local_mapping.create_depth_points(state, kf_id, K, bf, depth_limit)
    return state, kf_id


def insert_keyframe_fused_impl(state: MapState, frame: FrameData, K, bf, depth_limit: float, voc=None):
    """Keyframe insertion: append, depth densification, point cull,
    triangulate, fuse, stats, local BA, keyframe cull (the
    LocalMapping::Run body order). Returns (state, kf_id, cost, victim,
    victim_parent, T_redirect)."""
    state, kf_id = _append_keyframe_body(state, frame, K, bf, depth_limit)
    state = mapping_pre_ba(state, kf_id, K, bf, voc)
    with spans.span("local_ba"):
        state, cost = local_mapping.local_bundle_adjustment_impl(state, kf_id, K, bf)
    state, victim, vparent, T_redirect = mapping_post_ba(state, kf_id)
    return state, kf_id, cost, victim, vparent, T_redirect


# ---------------------------------------------------------------------------
# Split keyframe pipeline for the async runtime (runtime/pipeline.py):
# tracking appends the keyframe (cheap, CreateNewKeyFrame analog,
# src/Tracking.cc:1206-1286) and hands the mapping round to the
# LocalMapping worker (LocalMapping::Run body, src/LocalMapping.cc:47-120).
# Every update is out of place: `state` is a snapshot other threads hold.
# ---------------------------------------------------------------------------


def append_keyframe_only(state: MapState, frame: FrameData, K, bf, depth_limit: float):
    """Append + stereo/depth densification only. Returns (state, kf_id)."""
    return _append_keyframe_body(state, frame, K, bf, depth_limit)


def mapping_pre_ba(state: MapState, kf_id, K, bf, voc=None) -> MapState:
    """Mapping round up to the local BA: point cull, triangulation, fusion,
    the window's point statistics."""
    state = local_mapping.cull_map_points(state, kf_id)
    state = local_mapping.create_map_points(state, kf_id, K, bf, voc)
    state = local_mapping.fuse_map_points(state, kf_id, K, bf)
    return update_mp_stats_window(state, kf_id)


def mapping_post_ba(state: MapState, kf_id):
    """Keyframe culling + covisibility refresh after the local BA. Returns
    (state, victim, victim_parent, T_redirect)."""
    state, victim, vparent, T_redirect = local_mapping.cull_keyframes(state, kf_id)
    return refresh_covis(state), victim, vparent, T_redirect


def mapping_pipeline(state: MapState, kf_id, K, bf, allow_ba: bool = True, voc=None):
    """Worker-side mapping round on an already appended keyframe: cull,
    triangulate, fuse, stats and, unless interrupted, local BA, then the
    keyframe cull. `allow_ba=False` is the mbAbortBA path
    (src/LocalMapping.cc:126): a newer keyframe is waiting, skip the solve and
    catch up. Returns (state, victim, victim_parent, T_redirect)."""
    state = mapping_pre_ba(state, kf_id, K, bf, voc)
    if allow_ba:
        with spans.span("local_ba"):
            state, _ = local_mapping.local_bundle_adjustment_impl(state, kf_id, K, bf)
    return mapping_post_ba(state, kf_id)


def mapping_pipeline_dist(state: MapState, kf_id, K, bf, mesh, voc=None, allow_ba: bool = True):
    """`mapping_pipeline` with the window BA sharded over `mesh`
    (`local_mapping.local_bundle_adjustment_dist`): the route of
    `SlamSystem(mesh=...)`. Returns (state, victim, victim_parent,
    T_redirect)."""
    state = mapping_pre_ba(state, kf_id, K, bf, voc)
    if allow_ba:
        with spans.span("local_ba"):
            state, _ = local_mapping.local_bundle_adjustment_dist(state, kf_id, K, bf, mesh)
    return mapping_post_ba(state, kf_id)
