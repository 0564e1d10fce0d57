"""Local mapping: map-point creation, fusion, culling, windowed local BA.

Port of the JAX package's `models/local_mapping.py` (LocalMapping::
CreateNewMapPoints, SearchInNeighbors, MapPointCulling, KeyFrameCulling and
the Optimizer::LocalBundleAdjustment window). The reference's `vmap`s over
neighbour keyframes are a written-out leading dimension here; the 2 x 10
directed Fuse searches of a keyframe are one batched `match_projection`, so
one kernel launch on the card. The multi-device local BA is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import ba, hamming, lie, matching
from ..ops import vocab as vocab_ops
from ..ops.projection import project
from ..ops.topk import scatter_last, set_drop, stable_topk
from ..ops.triangulate import projection_matrix, triangulate
from .map_state import MapState, _mark, mp_observation_count, row_covisibility
from .tracking import LOG_SCALE, N_LEVELS, SCALE, inv_level_sigma2

TRI_NEIGHBORS = 10
NEW_MP_CAP = 384
BA_CAMS = 24
BA_FIXED = 8
BA_PTS = 4096
DEPTH_PT_CAP = 512


def _cam_centers(pose: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 3) world camera centers -R^T t."""
    return -(pose[..., :3, :3].transpose(-1, -2) @ pose[..., :3, 3:4])[..., 0]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, n]] for x (B, N, ...) and idx (B, Q)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def _set_rows(rows: torch.Tensor, sel: torch.Tensor, cols: torch.Tensor, values) -> torch.Tensor:
    """Per row b: `rows[b].at[where(sel, cols, N)].set(where(sel, values, -1),
    mode="drop")`; selected columns of a row are unique."""
    B, N = rows.shape
    pad = torch.cat([rows, torch.full((B, 1), -1, dtype=rows.dtype, device=rows.device)], dim=1)
    vals = torch.where(sel, values, -1).to(rows.dtype)
    return pad.scatter(1, torch.where(sel, cols, N).long(), vals)[:, :N]


def _alloc_free(state: MapState, want: torch.Tensor, cap: int):
    """Free-list allocation: the rank(j)-th wanted entry takes the rank-th
    free map-point slot. Returns (ok, slot) with slot = M where not taken."""
    M = state.max_mp
    rank = torch.cumsum(want.to(torch.int32), 0, dtype=torch.int32) - 1
    _, free_slots = stable_topk((~state.mp_valid).to(torch.int32), cap)
    n_free = torch.sum(~state.mp_valid, dtype=torch.int32)
    ok = want & (rank < cap) & (rank < n_free)
    slot = torch.where(ok, free_slots[torch.clamp(rank, max=cap - 1).long()], M)
    return ok, slot


def _append_points(state: MapState, slot, X, desc, kf_id) -> MapState:
    """Write new map points at `slot` (M = parked write)."""
    return state._replace(
        mp_pos=set_drop(state.mp_pos, slot, X),
        mp_valid=set_drop(state.mp_valid, slot, True),
        mp_desc=set_drop(state.mp_desc, slot, desc),
        mp_first_kf=set_drop(state.mp_first_kf, slot, kf_id.to(torch.int32)),
        mp_first_seq=set_drop(state.mp_first_seq, slot, state.kf_seq[kf_id]),
        mp_visible=set_drop(state.mp_visible, slot, 1),
        mp_found=set_drop(state.mp_found, slot, 1),
    )


def create_map_points(state: MapState, kf_id, K, bf, voc=None) -> MapState:
    """Triangulate new map points between the new keyframe and its
    TRI_NEIGHBORS best covisible neighbours, all pairs at once; a keypoint
    keeps its best-covisibility pair; one masked append grows the map."""
    N = state.n_kp
    M = state.max_mp
    row = row_covisibility(state, kf_id)
    neigh_w, neigh_idx = stable_topk(row, TRI_NEIGHBORS)
    good, X, m_idx = _triangulate_candidates(state, kf_id, neigh_idx, neigh_w > 0, K, bf, voc)

    good_any = torch.any(good, dim=0)
    chosen = torch.argmax(good.to(torch.int32), dim=0)  # first proposing pair
    sl = torch.arange(N, device=good.device)
    X_sel = X[chosen, sl]

    cap_ok, slot = _alloc_free(state, good_any, NEW_MP_CAP)
    kf_id = torch.as_tensor(kf_id, device=good.device)
    state = _append_points(state, slot, X_sel, state.kf_desc[kf_id], kf_id)

    new_id = torch.where(cap_ok, slot, -1)
    tsel = (chosen[None, :] == torch.arange(TRI_NEIGHBORS, device=good.device)[:, None]) & cap_ok[None, :]
    nrows = _set_rows(state.kf_mp[neigh_idx], tsel, m_idx, new_id[None, :].expand_as(tsel))
    kf_mp = state.kf_mp.clone()
    kf_mp[neigh_idx] = nrows
    kf_mp[kf_id] = torch.where(cap_ok, new_id, state.kf_mp[kf_id]).to(torch.int32)
    hw = torch.amax(torch.where(cap_ok, slot, -1)) + 1
    return state._replace(kf_mp=kf_mp, n_mp=torch.maximum(state.n_mp, hw.to(torch.int32)))


def _triangulate_candidates(state: MapState, kf1, kf2, pair_ok, K, bf, voc=None):
    """Match + triangulate + audit keyframe kf1 against each of kf2 (T,)
    without mutating the map; with a vocabulary, only keypoints sharing a
    coarse vocabulary-tree node are matched (SearchForTriangulation's
    FeatureVector alignment). Returns (good (T,N), X (T,N,3), m_idx (T,N))."""
    N = state.n_kp
    dev = state.kf_pose.device
    pose1 = state.kf_pose[kf1]
    pose2 = state.kf_pose[kf2]  # (T,4,4)
    c1 = _cam_centers(pose1)
    c2 = _cam_centers(pose2)
    baseline = torch.linalg.norm(c2 - c1, dim=-1)

    mp2 = state.kf_mp[kf2]
    has2 = (mp2 >= 0) & state.kf_kp_valid[kf2]
    pz = torch.einsum("tj,tnj->tn", pose2[:, 2, :3], state.mp_pos[torch.clamp(mp2, min=0).long()])
    pz = pz + pose2[:, 2, 3, None]
    pz = torch.where(has2, pz, torch.full_like(pz, float("nan")))
    median_depth = torch.nanquantile(pz, 0.5, dim=1)
    pair_ok = pair_ok & (baseline / torch.maximum(median_depth, torch.full_like(median_depth, 1e-6)) > 0.01)

    free1 = state.kf_kp_valid[kf1] & (state.kf_mp[kf1] < 0)
    free2 = state.kf_kp_valid[kf2] & (state.kf_mp[kf2] < 0)
    d1 = hamming.unpack_pm1(state.kf_desc[kf1])
    d2 = hamming.unpack_pm1(state.kf_desc[kf2])

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    Km = torch.stack([torch.stack([K[0], zero, K[2]]), torch.stack([zero, K[1], K[3]]),
                      torch.stack([zero, zero, one])])
    Kinv = torch.linalg.inv_ex(Km)[0]
    T12 = pose1 @ torch.linalg.inv_ex(pose2)[0]
    R12, t12 = T12[:, :3, :3], T12[:, :3, 3]
    z0 = torch.zeros_like(t12[:, 0])
    tx = torch.stack([
        torch.stack([z0, -t12[:, 2], t12[:, 1]], -1),
        torch.stack([t12[:, 2], z0, -t12[:, 0]], -1),
        torch.stack([-t12[:, 1], t12[:, 0], z0], -1),
    ], dim=-2)
    F12 = Kinv.T @ tx @ R12 @ Kinv
    ones = torch.ones((N, 1), dtype=torch.float32, device=dev)
    x1h = torch.cat([state.kf_xy[kf1], ones], -1)
    x2h = torch.cat([state.kf_xy[kf2], ones.expand(kf2.shape[0], N, 1)], -1)
    lines = x1h @ F12  # (T,N,3)
    num = torch.abs(lines @ x2h.transpose(-1, -2))
    den = torch.sqrt(torch.clamp(lines[..., 0] ** 2 + lines[..., 1] ** 2, min=1e-12))[..., None]
    epi_d2 = (num / den) ** 2
    sigma2_2 = torch.pow(SCALE, 2 * state.kf_level[kf2].to(torch.float32))
    epi_ok = epi_d2 < 3.84 * sigma2_2[:, None, :]

    mask = free1[None, :, None] & free2[:, None, :] & epi_ok
    if voc is not None:
        n1 = vocab_ops.assign_nodes(voc, state.kf_desc[kf1])
        n2 = vocab_ops.assign_nodes(voc, state.kf_desc[kf2])
        mask = mask & (n1[None, :, None] == n2[:, None, :])
    m = matching.match_nn(d1, d2, mask, max_dist=matching.TH_LOW, nn_ratio=1.0)
    dang = state.kf_angle[kf1][None, :] - _take(state.kf_angle[kf2], m.idx)
    ok = matching.rotation_consistency(dang, m.ok)
    m = matching.resolve_duplicates(m.idx, m.dist, ok, N)
    ok = m.ok & pair_ok[:, None]

    P1 = projection_matrix(pose1, K)
    P2 = projection_matrix(pose2, K)
    x1 = state.kf_xy[kf1]
    x2 = _take(state.kf_xy[kf2], m.idx)
    X = triangulate(P1, P2[:, None], x1.expand_as(x2), x2)

    r1 = X - c1
    r2 = X - c2[:, None, :]
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    cos_par = torch.sum(r1 * r2, -1) / torch.clamp(n1 * n2, min=1e-12)
    z1 = X @ pose1[2, :3] + pose1[2, 3]
    z2 = torch.einsum("tnj,tj->tn", X, pose2[:, 2, :3]) + pose2[:, 2, 3, None]

    s2_1 = torch.pow(SCALE, 2 * state.kf_level[kf1].to(torch.float32))
    s2_2m = _take(sigma2_2, m.idx)
    e1 = torch.sum((project(pose1, X, K) - x1) ** 2, dim=-1)
    e2 = torch.sum((project(pose2[:, None], X, K) - x2) ** 2, dim=-1)
    ratio_dist = n1 / torch.clamp(n2, min=1e-12)
    lvl2 = _take(state.kf_level[kf2], m.idx)
    ratio_octave = torch.pow(SCALE, (state.kf_level[kf1][None, :] - lvl2).to(torch.float32))
    scale_ok = (ratio_dist < ratio_octave * 1.5**1.5) & (ratio_dist > ratio_octave / (1.5**1.5))

    good = (
        ok
        & torch.all(torch.isfinite(X), -1)
        & (cos_par < 0.9998)
        & (z1 > 0)
        & (z2 > 0)
        & (e1 < 5.991 * s2_1)
        & (e2 < 5.991 * s2_2m)
        & scale_ok
    )
    return good, torch.where(good[..., None], X, torch.zeros_like(X)), m.idx


def create_depth_points(state: MapState, kf_id, K, bf, depth_limit: float) -> MapState:
    """Stereo/RGB-D densification: unmatched keypoints with depth become map
    points, all closer than depth_limit and at least the 100 closest."""
    M = state.max_mp
    u = state.kf_xy[kf_id, :, 0]
    v = state.kf_xy[kf_id, :, 1]
    ur = state.kf_ur[kf_id]
    disp = u - ur
    z = torch.where((ur >= 0) & (disp > 1e-6), bf / torch.clamp(disp, min=1e-6), -1.0)
    cand = state.kf_kp_valid[kf_id] & (state.kf_mp[kf_id] < 0) & (z > 0)
    order_key = torch.where(cand, z, float("inf"))
    rank = torch.argsort(torch.argsort(order_key, stable=True), stable=True)
    take = cand & ((z < depth_limit) | (rank < 100)) & (rank < DEPTH_PT_CAP)

    pose = state.kf_pose[kf_id]
    Twc_R = pose[:3, :3].T
    Twc_t = -Twc_R @ pose[:3, 3]
    xc = (u - K[2]) * z / K[0]
    yc = (v - K[3]) * z / K[1]
    Xw = torch.stack([xc, yc, z], -1) @ Twc_R.T + Twc_t

    ok, slot = _alloc_free(state, take, DEPTH_PT_CAP)
    kf_id = torch.as_tensor(kf_id, device=u.device)
    state = _append_points(state, slot, Xw, state.kf_desc[kf_id], kf_id)
    kf_mp = state.kf_mp.clone()
    kf_mp[kf_id] = torch.where(ok, slot, state.kf_mp[kf_id]).to(torch.int32)
    hw = torch.amax(torch.where(ok, slot, -1)) + 1
    return state._replace(kf_mp=kf_mp, n_mp=torch.maximum(state.n_mp, hw.to(torch.int32)))


def _fuse_candidates(state: MapState, src_kf, dst_kf, pair_ok, K):
    """Project each src keyframe's points into its dst keyframe and match
    (ORBmatcher::Fuse search phase), batched over pairs (B,), without
    mutating the map. Returns (ok, m_idx, m_dist, q_mp), each (B, N)."""
    M = state.max_mp
    B = src_kf.shape[0]
    dev = state.kf_pose.device
    q_mp = state.kf_mp[src_kf]
    qc = torch.clamp(q_mp, min=0).long()
    q_ok = (q_mp >= 0) & state.kf_kp_valid[src_kf] & pair_ok[:, None] & state.mp_valid[qc]
    dst_rows = state.kf_mp[dst_kf]
    dst_has = torch.zeros((B, M + 1), dtype=torch.bool, device=dev)
    dst_has.scatter_(1, torch.where(dst_rows >= 0, dst_rows, M).long(), True)
    q_ok = q_ok & ~torch.gather(dst_has, 1, qc)

    pose = state.kf_pose[dst_kf]
    pw = state.mp_pos[qc]
    uv = project(pose[:, None], pw, K)
    z = torch.einsum("bj,bnj->bn", pose[:, 2, :3], pw) + pose[:, 2, 3, None]
    po = pw - _cam_centers(pose)[:, None, :]
    dist = torch.linalg.norm(po, dim=-1)
    view_cos = torch.sum(po * state.mp_normal[qc], dim=-1) / torch.clamp(dist, min=1e-9)
    in_band = (dist >= state.mp_min_dist[qc]) & (dist <= state.mp_max_dist[qc])
    q_ok = q_ok & (z > 0) & in_band & (view_cos > 0.5)

    ratio = state.mp_max_dist[qc] / torch.clamp(dist, min=1e-9)
    pred_level = torch.clamp(
        torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / LOG_SCALE).to(torch.int32), 0, N_LEVELS - 1
    )
    radius = 3.0 * torch.pow(SCALE, pred_level.to(torch.float32))
    m = matching.match_projection(
        state.mp_desc[qc], uv, pred_level, q_ok,
        state.kf_desc[dst_kf], state.kf_xy[dst_kf], state.kf_level[dst_kf], state.kf_kp_valid[dst_kf],
        radius, max_dist=matching.TH_LOW, nn_ratio=1.0,
    )
    return m.ok, m.idx, m.dist, q_mp


def fuse_map_points(state: MapState, kf_id, K, bf) -> MapState:
    """SearchInNeighbors: two-way Fuse between the new keyframe and its best
    covisible neighbours against one map snapshot, then one bookkeeping
    pass; point merges collapse into a single replacement map."""
    N = state.n_kp
    M = state.max_mp
    T = TRI_NEIGHBORS
    dev = state.kf_pose.device
    row = row_covisibility(state, kf_id)
    neigh_w, neigh_idx = stable_topk(row, T)
    pair_ok = neigh_w > 0
    kf_vec = torch.as_tensor(kf_id, device=dev).reshape(1).expand(T)

    # Direction A (new KF's points -> each neighbour) and direction B (each
    # neighbour's points -> the new KF) as one batch of 2T searches.
    ok_, idx_, dist_, qmp_ = _fuse_candidates(
        state, torch.cat([kf_vec, neigh_idx]), torch.cat([neigh_idx, kf_vec]),
        torch.cat([pair_ok, pair_ok]), K,
    )
    okA, idxA, qmpA = ok_[:T], idx_[:T], qmp_[:T]
    okB, idxB, distB, qmpB = ok_[T:], idx_[T:], dist_[T:], qmp_[T:]

    obs = mp_observation_count(state)
    obs1 = torch.cat([obs, torch.zeros(1, dtype=torch.int32, device=dev)])  # -1 reads 0

    # --- apply A: per-neighbour row updates + merge pairs ---
    nrows = state.kf_mp[neigh_idx]
    existA = torch.gather(nrows, 1, idxA)
    srcA = torch.where(okA, qmpA, -1)
    addA = okA & (existA < 0)
    mergeA = okA & (existA >= 0) & (existA != srcA)
    kf_mp = state.kf_mp.clone()
    kf_mp[neigh_idx] = _set_rows(nrows, addA, idxA, srcA)

    # --- apply B: one dst row, cross-neighbour conflicts by best distance ---
    big = matching.BIG
    t_iota = torch.arange(T, device=dev)[:, None]
    dst_slot = torch.where(okB, idxB, N)
    prop_pt = torch.full((T, N + 1), -1, dtype=torch.int32, device=dev)
    prop_pt[t_iota, dst_slot] = torch.where(okB, qmpB, -1)
    prop_dist = torch.full((T, N + 1), big, dtype=torch.int32, device=dev)
    prop_dist = prop_dist.scatter_reduce(1, dst_slot, torch.where(okB, distB, big), reduce="amin")
    arN = torch.arange(N, device=dev)
    best_t = torch.argmin(prop_dist[:, :N], dim=0)
    dist_sel = prop_dist[best_t, arN]
    slot_sel = dist_sel < big
    srcB = torch.where(slot_sel, prop_pt[best_t, arN], -1)
    existB = kf_mp[kf_id]
    addB = slot_sel & (srcB >= 0) & (existB < 0)
    mergeB = slot_sel & (srcB >= 0) & (existB >= 0) & (existB != srcB)
    # Two neighbours can propose the same point for different slots: keep the
    # best distance, ties by slot order.
    srcBc = torch.clamp(srcB, min=0).long()
    pt_best = torch.full((M + 1,), big, dtype=torch.int32, device=dev)
    pt_best = pt_best.scatter_reduce(0, torch.where(addB, srcB, M).long(), dist_sel, reduce="amin")
    cand = addB & (dist_sel <= pt_best[srcBc])
    pt_first = torch.full((M + 1,), N, dtype=torch.int64, device=dev)
    pt_first = pt_first.scatter_reduce(0, torch.where(cand, srcB, M).long(), arN, reduce="amin")
    addB = cand & (pt_first[srcBc] == arN)
    kf_mp[kf_id] = torch.where(addB, srcB, existB)

    losers0 = torch.cat([torch.where(mergeA, existA, -1).reshape(-1), torch.where(mergeB, existB, -1)])
    srcs = torch.cat([torch.where(mergeA, srcA, -1).reshape(-1), torch.where(mergeB, srcB, -1)])
    rep = _replacement_map(M, losers0, srcs, obs1)
    kf_mp = torch.where(kf_mp >= 0, rep[torch.clamp(kf_mp, min=0).long()], kf_mp)
    mp_valid = state.mp_valid & (rep == torch.arange(M, device=dev))
    return state._replace(kf_mp=kf_mp, mp_valid=mp_valid)


def _replacement_map(M: int, losers0, srcs, obs1) -> torch.Tensor:
    """(M,) point id each point is replaced by (itself if kept), from merge
    pairs (losers0, srcs) with -1 for no merge: the point with fewer
    observations (obs1, with obs1[-1] = 0) is replaced. One loser can be
    proposed twice with different winners: the last proposal wins,
    deterministically, as XLA's in-order scatter applies it on the CPU."""
    keep_src = obs1[srcs.long()] >= obs1[losers0.long()]
    winner = torch.where(keep_src, srcs, losers0)
    loser = torch.where(keep_src, losers0, srcs)
    valid_merge = (losers0 >= 0) & (srcs >= 0)
    return scatter_last(
        torch.arange(M + 1, dtype=torch.int32, device=losers0.device),
        torch.where(valid_merge, loser, M), torch.where(valid_merge, winner, -1),
    )[:M]


def cull_map_points(state: MapState, current_kf) -> MapState:
    """MapPointCulling: drop recent points with found/visible < 0.25, or with
    too few observations a grace period after creation."""
    obs = mp_observation_count(state)
    found_ratio = state.mp_found.to(torch.float32) / torch.clamp(state.mp_visible.to(torch.float32), min=1.0)
    age = state.kf_seq[current_kf] - state.mp_first_seq
    bad = (found_ratio < 0.25) | ((age >= 2) & (obs <= 2))
    bad = bad & (age <= 3) & state.mp_valid
    mp_valid = state.mp_valid & ~bad
    dead = (state.kf_mp >= 0) & ~mp_valid[torch.clamp(state.kf_mp, min=0).long()]
    return state._replace(mp_valid=mp_valid, kf_mp=torch.where(dead, -1, state.kf_mp))


def cull_keyframes(state: MapState, kf_id, force: bool = False):
    """KeyFrameCulling + SetBadFlag erase of at most one redundant local
    keyframe (>= 90% of its points seen by >= 3 others at the same or finer
    scale; `force` evicts the most redundant eligible one). Returns
    (state, victim (-1 if none), parent, T_redirect)."""
    Kn, N = state.kf_mp.shape
    M = state.max_mp
    dev = state.kf_pose.device
    flat_mp = torch.where(
        state.kf_kp_valid & (state.kf_mp >= 0) & state.kf_valid[:, None], state.kf_mp, M
    ).reshape(-1).long()
    counts = torch.zeros(M + 1, dtype=torch.int32, device=dev).index_add(
        0, flat_mp, torch.ones_like(flat_mp, dtype=torch.int32))[:M]
    min_lvl = torch.full((M + 1,), 99, dtype=torch.int32, device=dev).scatter_reduce(
        0, flat_mp, state.kf_level.reshape(-1), reduce="amin")[:M]

    row = row_covisibility(state, kf_id)
    cand_mask = (row > 0) & state.kf_valid & (state.kf_parent >= 0)
    cand_mask = cand_mask.clone()
    cand_mask[kf_id] = False
    le = state.loop_edges.reshape(-1)
    on_loop = _mark(Kn + 1, torch.where(le >= 0, le, Kn), dev)[:Kn]
    cand_mask = cand_mask & ~on_loop

    mp = state.kf_mp
    has = (mp >= 0) & state.kf_kp_valid
    mpc = torch.clamp(mp, min=0).long()
    well_observed = (counts[mpc] >= 4) & (min_lvl[mpc] <= state.kf_level + 1)
    n_pts = torch.clamp(torch.sum(has, dim=1, dtype=torch.int32), min=1)
    n_red = torch.sum(has & well_observed, dim=1, dtype=torch.int32)
    ratio = n_red.to(torch.float32) / n_pts.to(torch.float32)

    red = (ratio > 0.9) & cand_mask
    if force:
        any_red = torch.any(cand_mask)
        victim = torch.argmax(torch.where(cand_mask, ratio, -1.0))
    else:
        any_red = torch.any(red)
        victim = torch.argmax(torch.where(red, state.kf_seq, -1))
    parent = state.kf_parent[victim]
    T_redirect = state.kf_pose[victim] @ lie.se3_inverse(state.kf_pose[torch.clamp(parent, min=0)])

    arK = torch.arange(Kn, device=dev)
    child = state.kf_valid & (state.kf_parent == victim)
    elig = (
        state.kf_valid[None, :]
        & (state.kf_seq[None, :] < state.kf_seq[:, None])
        & (arK[None, :] != victim)
    )
    score = torch.where(elig, state.covis, -1)
    best = torch.argmax(score, dim=1).to(torch.int32)
    has_best = torch.amax(score, dim=1) > 0
    new_parent = torch.where(child & any_red, torch.where(has_best, best, parent), state.kf_parent)

    vic = torch.where(any_red, victim, Kn)
    state = state._replace(
        kf_valid=set_drop(state.kf_valid, vic, False),
        kf_kp_valid=set_drop(state.kf_kp_valid, vic, False),
        kf_mp=set_drop(state.kf_mp, vic, -1),
        kf_seq=set_drop(state.kf_seq, vic, -1),
        kf_parent=set_drop(new_parent, vic, -1),
    )
    return state, torch.where(any_red, victim, -1), parent, T_redirect


class WindowBuild(NamedTuple):
    """Local-BA window + the bookkeeping needed to write results back."""

    win: ba.BAWindow
    cam_kf: torch.Tensor  # (C,)
    cam_used: torch.Tensor  # (C,) bool
    pt_sel: torch.Tensor  # (P,)
    pt_sel_valid: torch.Tensor  # (P,) bool
    kf_mp_w: torch.Tensor  # (C,N)


def build_local_ba_window(state: MapState, kf_id, K, bf) -> WindowBuild:
    """Free cameras = the keyframe + its best covisible neighbours; points =
    their observations; fixed cameras = other observers of those points."""
    Kmax, N = state.kf_mp.shape
    M = state.max_mp
    P = min(BA_PTS, M)
    dev = state.kf_pose.device

    w = row_covisibility(state, kf_id).clone()
    w[kf_id] = 1 << 20
    w = torch.where(state.kf_valid, w, -1)
    free_w, free_idx = stable_topk(w, min(BA_CAMS, Kmax))
    free_mask = torch.zeros(Kmax, dtype=torch.bool, device=dev)
    free_mask[free_idx] = free_w > 0

    mp_in = torch.where((state.kf_mp >= 0) & state.kf_kp_valid & free_mask[:, None], state.kf_mp, M)
    pt_mask = _mark(M + 1, mp_in, dev)[:M] & state.mp_valid
    _, pt_sel = stable_topk(pt_mask.to(torch.int32), P)
    pt_sel_valid = pt_mask[pt_sel]
    inv_pt = set_drop(
        torch.full((M,), P, dtype=torch.int64, device=dev),
        torch.where(pt_sel_valid, pt_sel, M), torch.arange(P, device=dev),
    )

    sees_sel = torch.any(
        (state.kf_mp >= 0) & state.kf_kp_valid & (inv_pt[torch.clamp(state.kf_mp, min=0).long()] < P), dim=1
    )
    fixed_cand = sees_sel & ~free_mask & state.kf_valid
    _, fixed_idx = stable_topk(fixed_cand.to(torch.int32), min(BA_FIXED, Kmax))
    fixed_valid = fixed_cand[fixed_idx]

    cam_kf = torch.cat([free_idx, fixed_idx])
    cam_used = torch.cat([free_mask[free_idx], fixed_valid])
    cam_fixed = torch.cat([torch.zeros_like(free_idx, dtype=torch.bool),
                           torch.ones_like(fixed_idx, dtype=torch.bool)]) | ~cam_used
    # Gauge anchor: always fix the oldest free camera (by insertion sequence).
    order_key = torch.where(cam_used & ~cam_fixed, state.kf_seq[cam_kf], 1 << 20)
    anchor = torch.argsort(order_key, stable=True)[:1]
    cam_fixed = cam_fixed.clone()
    cam_fixed[anchor] = True

    kf_mp_w = state.kf_mp[cam_kf]
    pt_idx = inv_pt[torch.clamp(kf_mp_w, min=0).long()]
    obs_valid = cam_used[:, None] & state.kf_kp_valid[cam_kf] & (kf_mp_w >= 0) & (pt_idx < P)
    level = torch.clamp(state.kf_level[cam_kf], 0, N_LEVELS - 1).long()
    win = ba.BAWindow(
        poses=state.kf_pose[cam_kf],
        points=state.mp_pos[pt_sel],
        pt_idx=torch.where(obs_valid, pt_idx, P),
        target=torch.cat([state.kf_xy[cam_kf], state.kf_ur[cam_kf][..., None]], -1),
        inv_sigma2=inv_level_sigma2(dev)[level],
        is_stereo=state.kf_ur[cam_kf] >= 0,
        valid=obs_valid,
        cam_fixed=cam_fixed,
        K=K,
        bf=bf,
    )
    return WindowBuild(win=win, cam_kf=cam_kf, cam_used=cam_used, pt_sel=pt_sel,
                       pt_sel_valid=pt_sel_valid, kf_mp_w=kf_mp_w)


def writeback_local_ba(state: MapState, wb: WindowBuild, poses, points, valid) -> MapState:
    """Write optimized poses/points back and detach outlier observations."""
    Kmax = state.max_kf
    M = state.max_mp
    kf_pose = set_drop(state.kf_pose, torch.where(wb.cam_used & ~wb.win.cam_fixed, wb.cam_kf, Kmax), poses)
    mp_pos = set_drop(state.mp_pos, torch.where(wb.pt_sel_valid, wb.pt_sel, M), points)
    killed = wb.win.valid & ~valid
    new_rows = torch.where(killed, -1, wb.kf_mp_w)
    kf_mp = set_drop(state.kf_mp, torch.where(wb.cam_used, wb.cam_kf, Kmax), new_rows)
    return state._replace(kf_pose=kf_pose, mp_pos=mp_pos, kf_mp=kf_mp)


def local_bundle_adjustment_impl(state: MapState, kf_id, K, bf):
    """Windowed local BA with the (4, 6) iteration budget of the mapping
    path. Returns (state, cost)."""
    wb = build_local_ba_window(state, kf_id, K, bf)
    win2, cost = ba.bundle_adjust_window(wb.win, iters1=4, iters2=6)
    return writeback_local_ba(state, wb, win2.poses, win2.points, win2.valid), cost
