"""Frame-rate tracking: motion model, reference keyframe, local map.

Port of the JAX package's `models/tracking.py`. Acceptance thresholds are
the reference's (>= 10 inliers after motion-model tracking, >= 30 after
local-map tracking, decided by the callers).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..ops import ba, hamming, matching
from ..ops import vocab as vocab_ops
from ..ops.projection import project
from ..ops.topk import set_drop, stable_topk
from .map_state import MapState, _mark

LOCAL_MP_CAP = 4096
MAX_LOCAL_KFS = 80
SCALE = 1.2
N_LEVELS = 8
INV_LEVEL_SIGMA2 = [1.0 / SCALE ** (2 * l) for l in range(N_LEVELS)]
# log(SCALE) in float32 arithmetic, as the reference's jnp.log(SCALE).
LOG_SCALE = float(torch.log(torch.tensor(SCALE, dtype=torch.float32)))


@functools.lru_cache(maxsize=8)
def inv_level_sigma2(device) -> torch.Tensor:
    return torch.tensor(INV_LEVEL_SIGMA2, dtype=torch.float32, device=device)


class FrameData(NamedTuple):
    """A tracked frame (fixed N feature slots)."""

    xy: torch.Tensor  # (N,2) undistorted pixel coords
    level: torch.Tensor  # (N,) i32
    angle: torch.Tensor  # (N,) f32
    desc: torch.Tensor  # (N,8) i32 descriptor words
    desc_pm1: torch.Tensor  # (N,256) f32 +-1
    kp_valid: torch.Tensor  # (N,) bool
    ur: torch.Tensor  # (N,) f32 stereo right-u (-1 mono)
    depth: torch.Tensor  # (N,) f32 (-1 unknown)
    pose: torch.Tensor  # (4,4) Tcw
    mp: torch.Tensor  # (N,) i32 map-point associations (-1 none)
    frame_id: torch.Tensor  # () i32


class TrackStats(NamedTuple):
    n_matches: torch.Tensor
    n_inliers: torch.Tensor


def frame_from_numpy(arrays: dict, device=None) -> FrameData:
    """FrameData on `device` (None: the card) from the reference's numpy
    arrays (uint32 desc -> words, bf16 desc_pm1 -> float32)."""
    device = device_mod.resolve(device)
    out = {}
    for name in FrameData._fields:
        a = np.asarray(arrays[name])
        if name == "desc":
            a = hamming.words_from_uint32(a)
        elif name == "desc_pm1":
            a = a.astype(np.float32)
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return FrameData(**out)


def frame_to_numpy(frame: FrameData) -> dict:
    return {
        name: hamming.words_to_uint32(t) if name == "desc" else t.detach().cpu().numpy()
        for name, t in zip(FrameData._fields, frame)
    }


def _level_pow(level: torch.Tensor) -> torch.Tensor:
    return torch.pow(SCALE, level.to(torch.float32))


def make_obs_from_frame(frame_xy, frame_ur, frame_level, mp_ids, valid) -> ba.Obs:
    """`ba.Obs` for motion-only optimization from frame slots."""
    n = frame_xy.shape[0]
    return ba.Obs(
        cam_idx=torch.zeros(n, dtype=torch.int32, device=frame_xy.device),
        pt_idx=torch.clamp(mp_ids, min=0),
        target=torch.cat([frame_xy, frame_ur[:, None]], dim=-1),
        inv_sigma2=inv_level_sigma2(frame_xy.device)[torch.clamp(frame_level, 0, N_LEVELS - 1).long()],
        is_stereo=frame_ur >= 0,
        valid=valid & (mp_ids >= 0),
    )


def _associate(N: int, ok, idx, values, base=None):
    """`base.at[where(ok, idx, N)].set(where(ok, values, -1), mode="drop")`
    with base = all -1 by default; targets are unique after
    resolve_duplicates."""
    if base is None:
        base = torch.full((N,), -1, dtype=torch.int32, device=idx.device)
    return set_drop(base, torch.where(ok, idx, N), torch.where(ok, values, -1))


def _optimize(state, cur, cur_mp, T0, K, bf):
    obs = make_obs_from_frame(cur.xy, cur.ur, cur.level, cur_mp, cur.kp_valid)
    Tcw, inlier_mask, n_inliers = ba.pose_optimization(T0, state.mp_pos, obs, K, bf)
    cur_mp = torch.where(inlier_mask | (cur_mp < 0), cur_mp, -1)
    return Tcw, cur_mp, n_inliers


def track_motion_model(state: MapState, cur: FrameData, last: FrameData, T_pred, K, bf,
                       radius_th: float, vo_points: bool = False):
    """SearchByProjection(cur, last, th) + PoseOptimization
    (Tracking::TrackWithMotionModel).

    `vo_points=True` (localization-only mode, stereo/RGB-D) also tracks
    against temporal points unprojected from the last frame's depth, the
    reference's visual-odometry points (UpdateLastFrame, src/Tracking.cc:
    962-1008): they steer the pose but never become associations."""
    q_mp = last.mp
    qc = torch.clamp(q_mp, min=0).long()
    has_mp = (q_mp >= 0) & last.kp_valid & state.mp_valid[qc]
    pw = state.mp_pos[qc]
    q_has = has_mp
    if vo_points:
        Twc_R = last.pose[:3, :3].T
        Twc_t = -Twc_R @ last.pose[:3, 3]
        z = last.depth
        xc = (last.xy[:, 0] - K[2]) * z / K[0]
        yc = (last.xy[:, 1] - K[3]) * z / K[1]
        pw_vo = torch.stack([xc, yc, z], -1) @ Twc_R.T + Twc_t
        use_vo = ~has_mp & last.kp_valid & (z > 0)
        pw = torch.where(use_vo[:, None], pw_vo, pw)
        q_has = has_mp | use_vo
    pred_xy = project(T_pred, pw, K)
    pc_z = (T_pred[2, :3] @ pw.T) + T_pred[2, 3]
    q_has = q_has & (pc_z > 0)

    radius = radius_th * _level_pow(last.level)
    m = matching.match_projection(
        last.desc, pred_xy, last.level, q_has, cur.desc, cur.xy, cur.level, cur.kp_valid,
        radius, max_dist=matching.TH_HIGH, nn_ratio=0.9,
    )
    dang = last.angle - cur.angle[m.idx]
    ok = matching.rotation_consistency(dang, m.ok)
    N = cur.mp.shape[0]
    n_matches = torch.sum(ok, dtype=torch.int32)
    if vo_points:
        # Optimize in last-frame slot space over explicit positions, so VO
        # points (no map id) count; only map-point matches are associated.
        tgt_ur = cur.ur[m.idx]
        obs = ba.Obs(
            cam_idx=torch.zeros(N, dtype=torch.int32, device=pw.device),
            pt_idx=torch.arange(N, dtype=torch.int32, device=pw.device),
            target=torch.cat([cur.xy[m.idx], tgt_ur[:, None]], dim=-1),
            inv_sigma2=inv_level_sigma2(pw.device)[torch.clamp(cur.level[m.idx], 0, N_LEVELS - 1).long()],
            is_stereo=tgt_ur >= 0,
            valid=ok,
        )
        Tcw, inlier_last, n_inliers = ba.pose_optimization(T_pred, pw, obs, K, bf)
        okm = ok & has_mp & inlier_last
        return Tcw, _associate(N, okm, m.idx, q_mp), TrackStats(n_matches=n_matches, n_inliers=n_inliers)
    cur_mp = _associate(N, ok, m.idx, q_mp)
    Tcw, cur_mp, n_inliers = _optimize(state, cur, cur_mp, T_pred, K, bf)
    return Tcw, cur_mp, TrackStats(n_matches=n_matches, n_inliers=n_inliers)


def track_reference_keyframe(state: MapState, cur: FrameData, ref_kf, T_init, K, bf, voc=None):
    """Match against the reference keyframe without a motion prior
    (Tracking::TrackReferenceKeyFrame): TH_LOW, ratio 0.7, rotation
    consistency, one-to-one. With a vocabulary, candidate pairs are pruned
    to those sharing a coarse vocabulary-tree node (SearchByBoW's
    FeatureVector alignment, as a mask on the dense match matrix)."""
    N = cur.xy.shape[0]
    q_desc = hamming.unpack_pm1(state.kf_desc[ref_kf])
    q_mp = state.kf_mp[ref_kf]
    q_valid = (q_mp >= 0) & state.kf_kp_valid[ref_kf] & state.mp_valid[torch.clamp(q_mp, min=0).long()]
    mask = q_valid[:, None] & cur.kp_valid[None, :]
    if voc is not None:
        nq = vocab_ops.assign_nodes(voc, state.kf_desc[ref_kf])
        mask = mask & (nq[:, None] == vocab_ops.assign_nodes(voc, cur.desc)[None, :])
    m = matching.match_nn(q_desc, cur.desc_pm1, mask, max_dist=matching.TH_LOW, nn_ratio=0.7)
    dang = state.kf_angle[ref_kf] - cur.angle[m.idx]
    ok = matching.rotation_consistency(dang, m.ok)
    m = matching.resolve_duplicates(m.idx, m.dist, ok & m.ok, N)
    ok = m.ok
    cur_mp = _associate(N, ok, m.idx, q_mp)
    n_matches = torch.sum(ok, dtype=torch.int32)
    Tcw, cur_mp, n_inliers = _optimize(state, cur, cur_mp, T_init, K, bf)
    return Tcw, cur_mp, TrackStats(n_matches=n_matches, n_inliers=n_inliers)


def _local_keyframes(state: MapState, cur_mp: torch.Tensor) -> torch.Tensor:
    """(K,) bool: keyframes sharing a map point with the current frame, plus
    the best covisible neighbours, capped at MAX_LOCAL_KFS."""
    K, N = state.kf_mp.shape
    M = state.max_mp
    cur_mask = _mark(M + 1, torch.where(cur_mp >= 0, cur_mp, M), cur_mp.device)
    # Index -1 (a valid slot without a point) wraps to the last entry, as in
    # the reference; the (kf_mp >= 0) term discards it.
    look = torch.clamp(torch.where(state.kf_kp_valid, state.kf_mp, M), -1, M).long()
    votes = torch.sum(cur_mask[look] & (state.kf_mp >= 0), dim=1, dtype=torch.int32)
    votes = votes * state.kf_valid
    k1 = votes > 0
    neigh_score = torch.sum(torch.where(k1[:, None], state.covis, 0), dim=0, dtype=torch.int32)
    score = votes * 1000 + neigh_score
    score = torch.where(state.kf_valid, score, -1)
    top_vals, top_idx = stable_topk(score, min(MAX_LOCAL_KFS, K))
    local = torch.zeros(K, dtype=torch.bool, device=score.device)
    local[top_idx] = top_vals > 0
    return local | k1


def track_local_map(state: MapState, cur: FrameData, Tcw, K, bf, view_cos_limit: float, img_wh):
    """SearchLocalPoints + pose optimization over the local map
    (Tracking::TrackLocalMap). img_wh = (width, height) Python numbers.
    Returns (state, Tcw, cur_mp, TrackStats)."""
    M = state.max_mp
    N = cur.xy.shape[0]
    dev = Tcw.device

    local_kf = _local_keyframes(state, cur.mp)
    mp_of_local = torch.where(
        (state.kf_mp >= 0) & state.kf_kp_valid & local_kf[:, None], state.kf_mp, M
    )
    local_mp = _mark(M + 1, mp_of_local, dev)[:M] & state.mp_valid
    _, mp_sel = stable_topk(local_mp.to(torch.int32), min(LOCAL_MP_CAP, M))
    sel_valid = local_mp[mp_sel]

    pw = state.mp_pos[mp_sel]
    pc = (Tcw[:3, :3] @ pw.T).T + Tcw[:3, 3]
    z = pc[:, 2]
    uv = project(Tcw, pw, K)
    in_img = (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0]) & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1])
    cam_center = -Tcw[:3, :3].T @ Tcw[:3, 3]
    po = pw - cam_center
    dist = torch.linalg.norm(po, dim=-1)
    in_band = (dist >= state.mp_min_dist[mp_sel]) & (dist <= state.mp_max_dist[mp_sel])
    view_cos = torch.sum(po * state.mp_normal[mp_sel], dim=-1) / torch.clamp(dist, min=1e-9)
    visible = sel_valid & (z > 0) & in_img & in_band & (view_cos > view_cos_limit)

    ratio = state.mp_max_dist[mp_sel] / torch.clamp(dist, min=1e-9)
    pred_level = torch.clamp(
        torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / LOG_SCALE).to(torch.int32), 0, N_LEVELS - 1
    )
    r = torch.where(view_cos > 0.998, 2.5, 4.0) * _level_pow(pred_level)

    already = _mark(M + 1, torch.where(cur.mp >= 0, cur.mp, M), dev)
    q_valid = visible & ~already[mp_sel]
    t_free = cur.kp_valid & (cur.mp < 0)

    m = matching.match_projection(
        state.mp_desc[mp_sel], uv, pred_level, q_valid, cur.desc, cur.xy, cur.level, t_free,
        r, max_dist=matching.TH_HIGH, nn_ratio=0.8,
    )
    cur_mp = _associate(N, m.ok, m.idx, mp_sel.to(torch.int32), base=cur.mp)
    Tcw2, cur_mp_in, n_inliers = _optimize(state, cur, cur_mp, Tcw, K, bf)

    ones = torch.ones_like(mp_sel, dtype=torch.int32)
    vis_ids = torch.where(visible, mp_sel, M)
    mp_visible = torch.cat([state.mp_visible, torch.zeros(1, dtype=torch.int32, device=dev)])
    mp_visible = mp_visible.index_add(0, vis_ids, ones)[:M]
    found_ids = torch.where(cur_mp_in >= 0, cur_mp_in, M).long()
    mp_found = torch.cat([state.mp_found, torch.zeros(1, dtype=torch.int32, device=dev)])
    mp_found = mp_found.index_add(0, found_ids, torch.ones_like(found_ids, dtype=torch.int32))[:M]
    state = state._replace(mp_visible=mp_visible, mp_found=mp_found)

    n_matches = torch.sum(cur_mp >= 0, dtype=torch.int32)
    return state, Tcw2, cur_mp_in, TrackStats(n_matches=n_matches, n_inliers=n_inliers)
