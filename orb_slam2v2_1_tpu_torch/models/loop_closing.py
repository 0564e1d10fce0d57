"""Loop detection, Sim3 computation, loop correction, global BA.

Port of the JAX package's `models/loop_closing.py` (the analog of the
`LoopClosing` thread): `DetectLoop` via the BoW database and the host-side
3-consecutive consistency check, `ComputeSim3` via descriptor matching and
batched Horn RANSAC, `CorrectLoop` via the essential-graph optimization and
the loop fusion, and `RunGlobalBundleAdjustment` via a whole-map BA, inline or
detached on a worker thread. Everything here is plain PyTorch except the
projection searches, which go through `ops.matching.match_projection`
(kernel 2 on CUDA tensors).

With a device mesh (`parallel.mesh.Mesh`, or a sequence of devices) of
more than one shard, the whole-map BA runs with its observations sharded
over the mesh (`global_bundle_adjustment_dist`, `parallel/dist_ba.py`), inline
and in the detached runner alike; without one, `run_global_bundle_adjustment`
builds a mesh over every visible card when there is more than one, as the
reference does over `jax.devices()`.

The RANSAC of `compute_sim3` draws from the reference's own key
(`kf_id * 131 + cand`) through `ops/prng.py`, so it picks the reference's
hypothesis sets on every device, and the normal equations of the pose graph
and the global BA are summed in index order (`ops/topk`), so a run is
repeatable, on the card too.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

import torch

from .. import sync
from ..ops import ba, hamming, lie, matching, pose_graph, prng, sim3solver
from ..ops import vocab as vocab_ops
from ..ops.projection import project
from ..ops.topk import scatter_last, set_drop, stable_topk
from ..parallel import dist_ba
from ..parallel import mesh as mesh_mod
from ..runtime.native import NativeFlag
from . import keyframe_database as kdb
from .map_state import MapState, _cam_centers, _mark, refresh_covis
from .tracking import LOG_SCALE, N_LEVELS, SCALE, _level_pow, inv_level_sigma2

MIN_SIM3_MATCHES = 20  # optimized inliers the reference accepts
MIN_TOTAL_MATCHES = 40  # total support after the wider projection search


class LoopConsistency:
    """Host-side 3-consecutive-group consistency check (DetectLoop)."""

    def __init__(self, required: int = 3):
        self.required = required
        self.prev_groups: list[tuple[set, int]] = []

    def update(self, cand_groups: list[set]) -> list[int]:
        """cand_groups: covisibility group (set of kf ids) per candidate.
        Returns candidate indices that reached the consistency threshold."""
        new_prev = []
        enough = []
        for gi, group in enumerate(cand_groups):
            consistent = 0
            for pg, count in self.prev_groups:
                if group & pg:
                    consistent = max(consistent, count + 1)
            new_prev.append((group, consistent))
            if consistent + 1 >= self.required:
                enough.append(gi)
        self.prev_groups = new_prev
        return enough


def match_keyframes(state: MapState, kf1, kf2, voc=None) -> matching.Matches:
    """Descriptor matching between two keyframes' map-point keypoints
    (SearchByBoW KF-KF: TH_LOW, ratio 0.75, rotation consistency; with a
    vocabulary, candidates are pruned to pairs sharing a coarse tree node)."""
    N = state.n_kp
    w1, w2 = state.kf_desc[kf1], state.kf_desc[kf2]
    v1 = state.kf_kp_valid[kf1] & (state.kf_mp[kf1] >= 0)
    v2 = state.kf_kp_valid[kf2] & (state.kf_mp[kf2] >= 0)
    mask = v1[:, None] & v2[None, :]
    if voc is not None:
        mask = mask & (vocab_ops.assign_nodes(voc, w1)[:, None] == vocab_ops.assign_nodes(voc, w2)[None, :])
    m = matching.match_nn(hamming.unpack_pm1(w1), hamming.unpack_pm1(w2), mask,
                          max_dist=matching.TH_LOW, nn_ratio=0.75)
    dang = state.kf_angle[kf1] - state.kf_angle[kf2][m.idx]
    ok = matching.rotation_consistency(dang, m.ok)
    return matching.resolve_duplicates(m.idx, m.dist, ok, N)


def _sim3_project(p, S, K):
    """Points (N,3) through the Sim3 S into the image: (uv (N,2), z > 0)."""
    pc = p @ S[:3, :3].T + S[:3, 3]
    z = torch.clamp(pc[:, 2], min=1e-6)
    return torch.stack([K[0] * pc[:, 0] / z + K[2], K[1] * pc[:, 1] / z + K[3]], -1), pc[:, 2] > 0


def compute_sim3(state: MapState, kf_cur, kf_cand, K, key: prng.Key | None = None,
                 fix_scale: bool = True, voc=None, sets: torch.Tensor | None = None):
    """ComputeSim3 for one candidate: match map points (BoW-node aligned),
    Horn RANSAC, widen with mutual SearchBySim3 matches, refine with
    OptimizeSim3 (>= 20 inliers), then a wider projection search for total
    support (>= 40). The RANSAC draws from `key`, or uses the given
    hypothesis `sets`. Returns (success, S12, n_inliers, n_total)."""
    m = match_keyframes(state, kf_cur, kf_cand, voc)
    N = state.n_kp

    pose_c = state.kf_pose[kf_cur]
    pose_l = state.kf_pose[kf_cand]
    mp_c_row, mp_l_row = state.kf_mp[kf_cur], state.kf_mp[kf_cand]
    has_c = (mp_c_row >= 0) & state.kf_kp_valid[kf_cur]
    has_l = (mp_l_row >= 0) & state.kf_kp_valid[kf_cand]
    # 3-D positions in each camera frame, slot-major.
    p1 = state.mp_pos[torch.clamp(mp_c_row, min=0).long()] @ pose_c[:3, :3].T + pose_c[:3, 3]
    p2_row = state.mp_pos[torch.clamp(mp_l_row, min=0).long()] @ pose_l[:3, :3].T + pose_l[:3, 3]
    uv1 = state.kf_xy[kf_cur]
    xy_l = state.kf_xy[kf_cand]
    lvl_c, lvl_l = state.kf_level[kf_cur], state.kf_level[kf_cand]
    s2_1 = torch.pow(SCALE, 2 * lvl_c.to(torch.float32))
    s2_2_row = torch.pow(SCALE, 2 * lvl_l.to(torch.float32))

    res = sim3solver.sim3_ransac(
        p1, p2_row[m.idx], uv1, xy_l[m.idx], s2_1, s2_2_row[m.idx], m.ok, K,
        key=key, sets=sets, fix_scale=fix_scale,
    )

    # SearchBySim3: widen the match set with pairs that agree mutually under
    # the RANSAC S12.
    S12_r = res.S12
    S21_r = lie.sim3_inverse(S12_r)
    w_cur, w_cand = state.kf_desc[kf_cur], state.kf_desc[kf_cand]
    v_cur, v_cand = state.kf_kp_valid[kf_cur], state.kf_kp_valid[kf_cand]
    r_cur, r_cand = 7.5 * _level_pow(lvl_c), 7.5 * _level_pow(lvl_l)

    uvA, frontA = _sim3_project(p2_row, S12_r, K)  # the candidate's points in the current image
    mA = matching.match_projection(
        w_cand, uvA, lvl_l, has_l & frontA, w_cur, uv1, lvl_c, v_cur, r_cand,
        max_dist=matching.TH_HIGH, nn_ratio=1.0,
    )
    uvB, frontB = _sim3_project(p1, S21_r, K)  # the current's points in the candidate image
    mB = matching.match_projection(
        w_cur, uvB, lvl_c, has_c & frontB, w_cand, xy_l, lvl_l, v_cand, r_cur,
        max_dist=matching.TH_HIGH, nn_ratio=1.0,
    )
    iota = torch.arange(N, device=mB.idx.device)
    mutual = mB.ok & mA.ok[mB.idx] & (mA.idx[mB.idx] == iota)
    m2_idx = torch.where(m.ok, m.idx, mB.idx)
    m2_ok = m.ok | (mutual & has_l[mB.idx])

    # OptimizeSim3 over the widened match set.
    S12, _, n_inl = sim3solver.optimize_sim3(
        p1, p2_row[m2_idx], uv1, xy_l[m2_idx], 1.0 / s2_1, 1.0 / s2_2_row[m2_idx], m2_ok, S12_r, K,
        fix_scale=fix_scale,
    )

    # Wider support: project the candidate's map points into the
    # current keyframe through the optimized S12 and count agreements.
    uv_pred, front = _sim3_project(p2_row, S12, K)
    mm = matching.match_projection(
        w_cand, uv_pred, lvl_l, has_l & front, w_cur, uv1, lvl_c, v_cur, r_cand,
        max_dist=matching.TH_HIGH, nn_ratio=1.0, level_lo=-1, level_hi=1,
    )
    n_total = torch.sum(mm.ok, dtype=torch.int32)
    success = res.success & (n_inl >= MIN_SIM3_MATCHES) & (n_total >= MIN_TOTAL_MATCHES)
    return success, S12, n_inl, n_total


def _oldest_observer(state: MapState) -> torch.Tensor:
    """(M,) slot id of each map point's oldest live observer. The reference
    keyframe is derived rather than stored: slot ids are reused after
    culling, so a stored slot may now hold an unrelated keyframe. The
    per-point minimum over observers of (kf_seq * K + slot) decodes to the
    oldest observer's slot; points with no live observer map to slot 0."""
    Kn = state.max_kf
    M = state.max_mp
    dev = state.kf_mp.device
    flat_mp = torch.where(
        state.kf_kp_valid & (state.kf_mp >= 0) & state.kf_valid[:, None], state.kf_mp, M
    )
    comb = state.kf_seq[:, None] * Kn + torch.arange(Kn, dtype=torch.int32, device=dev)[:, None]
    comb = comb.expand(flat_mp.shape)
    big = 2**31 - 1
    ref_comb = torch.full((M + 1,), big, dtype=torch.int32, device=dev)
    ref_comb = ref_comb.scatter_reduce(0, flat_mp.reshape(-1).long(), comb.reshape(-1), reduce="amin")[:M]
    return torch.where(ref_comb < big, ref_comb % Kn, 0).long()


def _move_with(points, T_old, T_new):
    """Points (M,3) re-expressed so that they keep their place in the camera
    whose pose goes from T_old to T_new (M,4,4): p' = T_new^-1 T_old p."""
    p_cam = torch.einsum("mij,mj->mi", T_old[:, :3, :3], points) + T_old[:, :3, 3]
    return torch.einsum("mji,mj->mi", T_new[:, :3, :3], p_cam - T_new[:, :3, 3])


def correct_loop(state: MapState, kf_cur, kf_loop, S_cur_loop: torch.Tensor) -> MapState:
    """CorrectLoop: essential-graph optimization with the measured loop edge
    (S_cur_loop maps loop-camera to current-camera coordinates), then
    map-point correction through each point's reference keyframe."""
    Kn = state.max_kf
    dev = state.kf_pose.device
    kf_cur = torch.as_tensor(kf_cur, device=dev).long()
    kf_loop = torch.as_tensor(kf_loop, device=dev).long()

    # The loop edge S_ji with i=loop, j=cur:
    # S_cur_w(corrected) = S_cur_loop @ S_loop_w.
    edges = pose_graph.build_edges_from_map(state, kf_loop, kf_cur, S_cur_loop)
    fixed = (torch.arange(Kn, device=dev) == kf_loop) | ~state.kf_valid
    old_poses = state.kf_pose
    corrected = pose_graph.optimize_pose_graph(old_poses, fixed, edges, iters=20)

    # Sim3 -> SE3 (t /= s).
    R, t, s = lie.sim3_parts(corrected)
    se3 = lie.make_se3(R, t / s[:, None])

    ref = _oldest_observer(state)
    p_new = _move_with(state.mp_pos, old_poses[ref], se3[ref])
    mp_pos = torch.where(state.mp_valid[:, None], p_new, state.mp_pos)
    kf_pose = torch.where(state.kf_valid[:, None, None], lie.orthonormalize(se3), state.kf_pose)

    # Record the loop edge persistently; the ring overwrites the oldest.
    slot = (state.n_loop_edges % state.loop_edges.shape[0]).long()
    loop_edges = state.loop_edges.clone()
    loop_edges[slot] = torch.stack([kf_cur, kf_loop]).to(torch.int32)
    return state._replace(
        kf_pose=kf_pose, mp_pos=mp_pos, loop_edges=loop_edges, n_loop_edges=state.n_loop_edges + 1,
    )


# Default capacities for the corrected neighbourhood and the loop-side point
# set. The host sizes the actual call to cover the live corrected group
# (`_fuse_caps`); these are the smallest buckets, not truncation caps.
LOOP_FUSE_KFS = 16
LOOP_MP_CAP = 4096


def _loop_side_points(state: MapState, kf_loop) -> torch.Tensor:
    """(M,) bool: valid points observed by the loop keyframe's covisible
    group."""
    Kn = state.max_kf
    M = state.max_mp
    dev = state.kf_mp.device
    grp = (state.covis[kf_loop] > 0) | (torch.arange(Kn, device=dev) == kf_loop)
    mp_in = torch.where((state.kf_mp >= 0) & state.kf_kp_valid & grp[:, None], state.kf_mp, M)
    return _mark(M + 1, mp_in, dev)[:M] & state.mp_valid


def search_and_fuse(state: MapState, kf_cur, kf_loop, K, fuse_kfs: int = LOOP_FUSE_KFS,
                    mp_cap: int = LOOP_MP_CAP):
    """Loop fusion (SearchAndFuse + the CorrectLoop merge pass): project the
    loop side's map points into the corrected keyframes (the current
    keyframe's covisible group) and merge duplicates; the loop point always
    wins. Runs after the essential-graph correction, so plain pinhole
    projection with the corrected SE3 poses is the right model. All target
    keyframes fuse against the same snapshot in one batched search of shape
    T x P x N; the merge map is applied in one pass. Returns (state,
    n_fused)."""
    Kn, N = state.kf_mp.shape
    M = state.max_mp
    dev = state.kf_mp.device
    kf_cur = torch.as_tensor(kf_cur, device=dev).long()
    kf_loop = torch.as_tensor(kf_loop, device=dev).long()

    # Corrected neighbourhood: the current keyframe + its best covisible ones.
    w = state.covis[kf_cur].clone()
    w[kf_cur] = 1 << 20
    w = torch.where(state.kf_valid, w, -1)
    tgt_w, tgt_kfs = stable_topk(w, min(fuse_kfs, Kn))
    tgt_ok = tgt_w > 0
    T = tgt_kfs.shape[0]

    # Loop-side points.
    lp_mask = _loop_side_points(state, kf_loop)
    _, lp_sel = stable_topk(lp_mask.to(torch.int32), min(mp_cap, M))
    lp_ok = lp_mask[lp_sel]
    lp_pos = state.mp_pos[lp_sel]
    P = lp_sel.shape[0]

    pose = state.kf_pose[tgt_kfs]  # (T,4,4)
    uv = project(pose[:, None], lp_pos[None], K)  # (T,P,2)
    z = torch.einsum("tj,pj->tp", pose[:, 2, :3], lp_pos) + pose[:, 2, 3, None]
    dist = torch.linalg.norm(lp_pos[None] - _cam_centers(pose)[:, None], dim=-1)
    min_d, max_d = state.mp_min_dist[lp_sel], state.mp_max_dist[lp_sel]
    in_band = (dist >= min_d) & (dist <= max_d)
    ratio = max_d / torch.clamp(dist, min=1e-9)
    pred_level = torch.clamp(
        torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / LOG_SCALE).to(torch.int32), 0, N_LEVELS - 1
    )
    # Skip points the target already observes.
    rows = state.kf_mp[tgt_kfs]  # (T,N)
    dst_has = torch.zeros((T, M + 1), dtype=torch.bool, device=dev)
    dst_has.scatter_(1, torch.where(rows >= 0, rows, M).long(), True)
    q_ok = lp_ok & tgt_ok[:, None] & (z > 0) & in_band & ~dst_has[:, lp_sel]
    mm = matching.match_projection(
        state.mp_desc[lp_sel].expand(T, P, 8), uv, pred_level, q_ok,
        state.kf_desc[tgt_kfs], state.kf_xy[tgt_kfs], state.kf_level[tgt_kfs], state.kf_kp_valid[tgt_kfs],
        4.0 * _level_pow(pred_level), max_dist=matching.TH_LOW, nn_ratio=1.0,
    )
    okT, idxT = mm.ok, mm.idx  # (T,P) each

    # Apply: where the target slot holds a point, merge (the loop point
    # wins); where it is empty, adopt the loop point.
    exist = torch.gather(rows, 1, idxT)
    lp_ids = lp_sel.to(torch.int32).expand(T, P)
    add = okT & (exist < 0)
    merge = okT & (exist >= 0) & (exist != lp_ids)
    rows = torch.cat([rows, torch.full((T, 1), -1, dtype=rows.dtype, device=dev)], dim=1)
    rows = rows.scatter(1, torch.where(add, idxT, N), torch.where(add, lp_ids, -1))[:, :N]
    kf_mp = state.kf_mp.clone()
    kf_mp[tgt_kfs] = rows

    # Merge map: the existing (duplicated) landmark is replaced by the loop
    # landmark everywhere; of several winners for one loser the last stays.
    loser = torch.where(merge, exist, -1).reshape(-1)
    winner = torch.where(merge, lp_ids, -1).reshape(-1)
    rep = scatter_last(torch.arange(M + 1, dtype=torch.int32, device=dev),
                       torch.where(loser >= 0, loser, M), winner)[:M]
    kf_mp = torch.where(kf_mp >= 0, rep[torch.clamp(kf_mp, min=0).long()], kf_mp)
    mp_valid = state.mp_valid & (rep == torch.arange(M, device=dev))
    n_fused = torch.sum(merge, dtype=torch.int32) + torch.sum(add, dtype=torch.int32)
    return state._replace(kf_mp=kf_mp, mp_valid=mp_valid), n_fused


def _gba_problem(state: MapState, K, bf, cam_slots, cam_used) -> ba.BAProblem:
    """BA problem over the keyframe slots `cam_slots` (C,), of which
    `cam_used` are live; the gauge anchor is the oldest live keyframe by
    insertion sequence."""
    C = cam_slots.shape[0]
    N = state.n_kp
    dev = state.kf_mp.device
    seq_key = torch.where(cam_used, state.kf_seq[cam_slots], 2**30)
    anchor = torch.argmin(seq_key)
    cam_fixed = (torch.arange(C, device=dev) == anchor) | ~cam_used

    kf_mp = state.kf_mp[cam_slots]
    pt = torch.clamp(kf_mp, min=0)
    flat_ok = cam_used[:, None] & state.kf_kp_valid[cam_slots] & (kf_mp >= 0) & state.mp_valid[pt.long()]
    ur = state.kf_ur[cam_slots]
    obs = ba.Obs(
        cam_idx=torch.arange(C, dtype=torch.int32, device=dev)[:, None].expand(C, N).reshape(-1),
        pt_idx=pt.reshape(-1),
        target=torch.cat([state.kf_xy[cam_slots], ur[..., None]], -1).reshape(-1, 3),
        inv_sigma2=inv_level_sigma2(dev)[torch.clamp(state.kf_level[cam_slots], 0, N_LEVELS - 1).long()].reshape(-1),
        is_stereo=(ur >= 0).reshape(-1),
        valid=flat_ok.reshape(-1),
    )
    return ba.BAProblem(poses=state.kf_pose[cam_slots], points=state.mp_pos, obs=obs,
                        cam_fixed=cam_fixed, K=K, bf=bf)


def build_global_ba_problem(state: MapState, K, bf) -> ba.BAProblem:
    """Whole-map BA problem (GlobalBundleAdjustemnt): every live keyframe,
    point and observation, sized by the map's capacity. Camera slots map
    1:1."""
    return _gba_problem(state, K, bf, torch.arange(state.max_kf, device=state.kf_mp.device), state.kf_valid)


def apply_global_ba_result(state: MapState, poses, points, cam_fixed) -> MapState:
    """Write optimized poses and points back into the live slots."""
    kf_pose = torch.where((state.kf_valid & ~cam_fixed)[:, None, None], poses, state.kf_pose)
    mp_pos = torch.where(state.mp_valid[:, None], points, state.mp_pos)
    return state._replace(kf_pose=kf_pose, mp_pos=mp_pos)


def global_bundle_adjustment(state: MapState, K, bf):
    """Whole-map BA on one device: 5 robust + 10 plain LM iterations with a
    chi2 cull between. Invalid slots ride along as zero-weight
    observations. Returns (state, cost)."""
    prob = build_global_ba_problem(state, K, bf)
    prob2, cost = ba.bundle_adjust(prob, cg_iters=32)
    return apply_global_ba_result(state, prob2.poses, prob2.points, prob.cam_fixed), cost


def build_global_ba_problem_compact(state: MapState, K, bf, kb: int):
    """GBA problem over the live keyframes compacted into `kb` camera slots
    (bucketed by the caller): the observation list shrinks from Kmax*N to
    kb*N, so the solve is sized by the map, not its capacity. Returns (prob,
    cam_slots (kb,), cam_used (kb,))."""
    _, cam_slots = stable_topk(state.kf_valid.to(torch.int8), kb)
    cam_used = state.kf_valid[cam_slots]
    return _gba_problem(state, K, bf, cam_slots, cam_used), cam_slots, cam_used


def expand_gba_result(snap_poses, opt_poses, cam_fixed, cam_slots, cam_used):
    """Scatter compact GBA camera results back to full keyframe slots;
    returns (poses (K,4,4), cam_fixed_full (K,)) in the layout
    `merge_gba_into_live` / `apply_global_ba_result` expect."""
    Kmax = snap_poses.shape[0]
    tgt = torch.where(cam_used & ~cam_fixed, cam_slots, Kmax)
    full = set_drop(snap_poses, tgt, opt_poses)
    fixed_full = set_drop(torch.ones(Kmax, dtype=torch.bool, device=snap_poses.device), tgt, False)
    return full, fixed_full


def global_bundle_adjustment_dist(state: MapState, K, bf, mesh):
    """Whole-map BA with its observations sharded over `mesh` (a
    `parallel.mesh.Mesh`): the single-device schedule (5 robust + 10 plain LM
    iterations, `cg_iters=32`) through `parallel.dist_ba`. Kmax*N
    observations divide evenly over a power-of-two mesh. Returns (state,
    cost)."""
    prob = build_global_ba_problem(state, K, bf)
    solve = dist_ba.make_sharded_bundle_adjust(mesh, iters1=5, iters2=10, cg_iters=32, label="global_ba")
    poses, points, _, cost = solve(prob.poses, prob.points, prob.obs, prob.cam_fixed, K, bf)
    dev = state.kf_pose.device
    return apply_global_ba_result(state, poses.to(dev), points.to(dev), prob.cam_fixed), cost


def run_global_bundle_adjustment(state: MapState, K, bf, mesh=None):
    """Routing of the inline global BA: a mesh of more than one shard gets
    the sharded solve, else the single-device one. `mesh=None` builds a mesh
    over every visible card when there is more than one (for a map on the
    card)."""
    mesh = mesh_mod.resolve("auto" if mesh is None and state.kf_pose.is_cuda else mesh)
    if mesh is not None:
        return global_bundle_adjustment_dist(state, K, bf, mesh)
    return global_bundle_adjustment(state, K, bf)


def merge_gba_into_live(live: MapState, snap_kf_seq, snap_kf_valid, snap_mp_first_seq, snap_mp_valid,
                        opt_poses, opt_points, cam_fixed) -> MapState:
    """Fold a detached GBA result into the live map: keyframes that existed
    at the snapshot take their optimized poses; keyframes born during the
    solve are corrected by propagating their parent's correction down the
    spanning tree; map points born during the solve move with their oldest
    live observer. Slot reuse is handled by identity checks on kf_seq /
    mp_first_seq: a slot whose sequence number changed holds another
    keyframe or point than the one the solver saw."""
    par = torch.clamp(live.kf_parent, min=0).long()
    same_kf = live.kf_valid & snap_kf_valid & (live.kf_seq == snap_kf_seq)
    old_poses = live.kf_pose
    new_poses = torch.where((same_kf & ~cam_fixed)[:, None, None], opt_poses, old_poses)
    updated = same_kf

    # T_child_new = (T_child_old @ T_parent_old^-1) @ T_parent_new, swept down
    # the tree until no child with an updated parent remains (one host read
    # per sweep; kf_seq ordering makes the tree acyclic).
    T_rel = old_poses @ lie.se3_inverse(old_poses[par])
    while True:
        todo = live.kf_valid & ~updated & (live.kf_parent >= 0) & updated[par]
        if not sync.host(torch.any(todo)):
            break
        new_poses = torch.where(todo[:, None, None], T_rel @ new_poses[par], new_poses)
        updated = updated | todo

    same_mp = live.mp_valid & snap_mp_valid & (live.mp_first_seq == snap_mp_first_seq)
    mp_pos = torch.where(same_mp[:, None], opt_points, live.mp_pos)
    ref = _oldest_observer(live)
    p_corr = _move_with(live.mp_pos, old_poses[ref], new_poses[ref])
    born = live.mp_valid & ~same_mp
    mp_pos = torch.where(born[:, None], p_corr, mp_pos)
    return live._replace(kf_pose=new_poses, mp_pos=mp_pos)


# The GBA stop flag (`mbStopGBA`): the native runtime's atomic flag, with
# `set`, `clear` and truth.
StopFlag = NativeFlag


class GlobalBARunner:
    """Detached, abortable global BA: the reference's per-loop GBA thread
    with its stop flag checked between LM chunks.

    The solve runs on a snapshot (a deep copy) of the map on a worker thread,
    in chunks of `chunk_iters` LM iterations with the damping threaded
    through; keyframe insertion proceeds meanwhile. The worker launches on
    the default stream and waits for each chunk by reading its convergence
    flag. With a `mesh` of more than one shard the chunks run sharded
    (`parallel.dist_ba.get_sharded_lm_chunk`). `result` holds (snapshot
    identity arrays, optimized poses and points, cam_fixed) when the solve
    finishes un-aborted; the owner folds it in with `merge_gba_into_live`.
    An exception in the worker is raised by `join`."""

    def __init__(self, K, bf, chunk_iters: int = 3, cg_iters: int = 32, mesh=None,
                 dense_max_cams: int = 128):
        self.mesh = mesh_mod.resolve(mesh)
        self.K = K
        self.bf = bf
        self.chunk_iters = chunk_iters
        self.cg_iters = cg_iters
        self.dense_max_cams = dense_max_cams
        self.stop_flag = StopFlag()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.result = None
        self.aborted = False
        self.n_runs = 0
        self.n_aborted = 0
        self.solve_ms = deque(maxlen=8)  # wall clock of recent solves
        self.chunk_ms = deque(maxlen=64)  # wall clock of their chunks of LM iterations

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self, snapshot: MapState) -> None:
        if self.running:
            raise RuntimeError("GBA already in flight")
        self.stop_flag.clear()
        self.result = None
        self.aborted = False
        # Deep-copy now, on the caller's thread: the caller goes on changing
        # its map while this solve reads the copy.
        self._snapshot = MapState(*(t.clone() for t in snapshot))
        self._thread = threading.Thread(target=self._run_guarded, daemon=True)
        self._thread.start()

    def abort(self) -> None:
        """Request cooperative cancellation."""
        self.stop_flag.set(1)

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _chunks(self, prob: ba.BAProblem, total: int, robust: bool):
        lam = 1e-4
        done = 0
        dense = prob.poses.shape[0] <= self.dense_max_cams
        while done < total:
            # Always a full chunk (may overshoot `total` by < chunk_iters),
            # as the reference: an extra LM iteration near convergence is
            # free accuracy.
            t0 = time.perf_counter()
            if self.mesh is not None:
                chunk = dist_ba.get_sharded_lm_chunk(self.mesh, iters=self.chunk_iters, robust=robust,
                                                     cg_iters=self.cg_iters)
                poses, points, lam, converged = chunk(prob.poses, prob.points, prob.obs, prob.cam_fixed, prob.K,
                                                      prob.bf, lam)  # reads each iteration's exit flag
                dev = prob.poses.device
                prob = prob._replace(poses=poses.to(dev), points=points.to(dev))
            else:
                prob, _, lam, conv = ba.ba_step_count_lam(
                    prob, lam, iters=self.chunk_iters, cg_iters=self.cg_iters, robust=robust, dense=dense)
                converged = sync.host(conv)  # waits for the chunk
            self.chunk_ms.append((time.perf_counter() - t0) * 1e3)
            done += self.chunk_iters
            if self.stop_flag:
                return prob, True
            if converged:
                break
        return prob, False

    def _run_guarded(self) -> None:
        sync.set_role("gba")
        dev = self._snapshot.kf_pose.device
        try:
            # A new thread starts on device 0: launch on the snapshot's card.
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                self._run()
        except BaseException as exc:  # handed to the owner by join()
            self._error = exc

    def _run(self) -> None:
        t0 = time.perf_counter()
        self.n_runs += 1
        snap = self._snapshot
        # Compact the problem to the live keyframes (bucketed).
        n_live = sync.host(torch.sum(snap.kf_valid, dtype=torch.int32))
        kb = _bucket(n_live, 16, snap.max_kf)
        prob, cam_slots, cam_used = build_global_ba_problem_compact(snap, self.K, self.bf, kb)
        prob, aborted = self._chunks(prob, 5, robust=True)
        if not aborted:
            prob = ba.classify_outliers(prob)
            prob, aborted = self._chunks(prob, 10, robust=False)
        self.aborted = aborted
        self.solve_ms.append((time.perf_counter() - t0) * 1e3)
        if aborted:
            self.n_aborted += 1
            return
        poses_full, fixed_full = expand_gba_result(snap.kf_pose, prob.poses, prob.cam_fixed, cam_slots, cam_used)
        self.result = (snap.kf_seq, snap.kf_valid, snap.mp_first_seq, snap.mp_valid,
                       poses_full, prob.points, fixed_full)


def _bucket(n: int, floor: int, cap: int) -> int:
    """Round n up to the next power-of-two bucket in [floor, cap]."""
    b = floor
    while b < min(n, cap):
        b *= 2
    return min(b, cap)


def _fuse_sizes(state: MapState, kf_cur, kf_loop):
    """Live sizes of the corrected keyframe group and the loop-side point
    set, as 0-dim tensors."""
    n_grp = torch.sum((state.covis[kf_cur] > 0) & state.kf_valid, dtype=torch.int32) + 1
    return n_grp, torch.sum(_loop_side_points(state, kf_loop), dtype=torch.int32)


def _fuse_caps(state: MapState, kf_cur: int, kf_loop: int):
    """Fuse capacities covering the live corrected set. The reference
    buckets them to bound recompiles; the buckets stay because they decide
    which points the top-k keeps, and in what order."""
    n_grp, n_lp = sync.host(torch.stack(_fuse_sizes(state, kf_cur, kf_loop)))
    return _bucket(n_grp, LOOP_FUSE_KFS, state.max_kf), _bucket(n_lp, LOOP_MP_CAP, state.max_mp)


class LoopCloser:
    """Host-side orchestration of the loop pipeline (the LoopClosing thread
    analog). Call `on_keyframe` after each insertion, or `detect_batch` /
    `apply_closure` per chunk of insertions."""

    def __init__(self, vocab, db, fix_scale: bool, K, bf, mesh=None):
        self.vocab = vocab
        self.db = db
        self.fix_scale = fix_scale
        self.K = K
        self.bf = bf
        self.mesh = mesh_mod.resolve(mesh)
        # Detached GBA: the solve runs on its own thread on a snapshot,
        # abortable between LM chunks; results are merged by `service_gba`.
        self.detached_gba = False
        self.gba_runner: GlobalBARunner | None = None
        self._gba_pending = False
        self.n_gba_merged = 0
        self.consistency = LoopConsistency()
        # Cooldown bookkeeping in insertion order: slot ids are reused by the
        # free list, so differences of slots mean nothing.
        self.kf_counter = 0
        self.last_loop_seq = -(1 << 30)
        self.n_loops_closed = 0
        self.closures: list[tuple[int, int, int]] = []  # (insertion count, keyframe, loop keyframe) of each
        # Detection rounds skipped because an earlier keyframe in the same
        # batch already triggered a closure (counted, not silent).
        self.n_detect_suppressed = 0

    def enable_detached_gba(self, chunk_iters: int = 3) -> None:
        self.detached_gba = True
        if self.gba_runner is None:
            self.gba_runner = GlobalBARunner(self.K, self.bf, chunk_iters=chunk_iters, mesh=self.mesh)

    def _merge(self, box) -> None:
        res, self.gba_runner.result = self.gba_runner.result, None
        box.mutate(lambda live: merge_gba_into_live(live, *res))
        self.n_gba_merged += 1

    def service_gba(self, box) -> bool:
        """Merge a finished detached solve into the live map and/or start a
        pending one. `box` has `read() -> (state, version)` and
        `mutate(fn)`. Returns True if a result was merged."""
        r = self.gba_runner
        if r is None:
            return False
        merged = False
        if not r.running and r.result is not None and not self._gba_pending:
            r.join()
            self._merge(box)
            merged = True
        if self._gba_pending:
            if r.running:
                # A newer loop superseded the in-flight solve.
                r.abort()
            r.join()
            r.result = None  # a stale pre-correction result is worthless
            self._gba_pending = False
            snap, _ = box.read()
            r.start(snap)
        return merged

    def finalize_gba(self, box) -> None:
        """Shutdown barrier: let any in-flight or pending solve finish and
        merge it."""
        r = self.gba_runner
        if r is None:
            return
        if self._gba_pending and not r.running:
            self._gba_pending = False
            snap, _ = box.read()
            r.start(snap)
        r.join()
        if r.result is not None:
            self._merge(box)

    def _try_candidates(self, state: MapState, kf_id: int, cands, scores, consistent):
        """Sim3 on the consistent candidates, strongest first, at most 3.
        Returns (cand, S12) of the first accepted one, else None."""
        order = sorted(consistent, key=lambda gi: -scores[cands[gi]])
        for gi in order[:3]:
            cand = int(cands[gi])
            success, S12, _, _ = compute_sim3(
                state, kf_id, cand, self.K, prng.key(kf_id * 131 + cand),
                fix_scale=self.fix_scale, voc=self.vocab,
            )
            if sync.host(success):
                return cand, S12
        return None

    def _consistent(self, cands, C):
        groups = [set(C[c].nonzero()[0].tolist()) | {int(c)} for c in cands]
        return self.consistency.update(groups)

    def detect_loop(self, state: MapState, kf_id: int, n_kf: int):
        """Detection half of a round (DetectLoop + ComputeSim3): BoW
        registration, candidate retrieval, 3-consecutive consistency and
        Sim3 acceptance. Read-only on `state` (only `self.db` and the
        consistency chain change). Returns (cand, S12) for an accepted
        closure, else None."""
        # No detection within 10 keyframes of the last loop, counted in
        # insertion order.
        self.kf_counter += 1
        if n_kf < 12 or self.kf_counter - self.last_loop_seq < 10:
            self.db = kdb.add_keyframe_from_state(self.db, self.vocab, state, kf_id)
            self.consistency.update([])
            return None

        self.db, scores_d, cand_d = kdb.add_and_detect(self.db, self.vocab, state, kf_id)
        scores, cand_mask, C = sync.host_numpy(scores_d, cand_d, state.covis)
        cands = cand_mask.nonzero()[0]
        if len(cands) == 0:
            self.consistency.update([])
            return None
        consistent = self._consistent(cands, C)
        if not consistent:
            return None
        return self._try_candidates(state, kf_id, cands, scores, consistent)

    def detect_batch(self, state: MapState, slots: list, n_live: int):
        """Detection for a chunk of freshly inserted keyframes in one batched
        add + detect and one host read, processed in insertion order through
        the consistency chain. Returns accepted closures as [(kf_id, cand,
        S12)] (at most one: a closure resets the consistency chain and
        starts the cooldown)."""
        if not slots:
            return []
        S = _bucket(len(slots), 8, max(8, state.max_kf))
        arr = torch.tensor(list(slots) + [-1] * (S - len(slots)), dtype=torch.int64,
                           device=state.kf_pose.device)
        self.db, scores_d, cand_d = kdb.add_and_detect_batch(self.db, self.vocab, state, arr)
        scores, cand, C = sync.host_numpy(scores_d, cand_d, state.covis)
        triggers = []
        for i, slot in enumerate(slots):
            self.kf_counter += 1
            if triggers:
                # One closure per round: a second trigger would land inside
                # the cooldown between closures, so only its detection round
                # is skipped (counted); the candidates stay registered in
                # the database for future rounds.
                self.n_detect_suppressed += 1
                self.consistency.update([])
                continue
            if n_live < 12 or self.kf_counter - self.last_loop_seq < 10:
                self.consistency.update([])
                continue
            cands = cand[i].nonzero()[0]
            if len(cands) == 0:
                self.consistency.update([])
                continue
            consistent = self._consistent(cands, C)
            if not consistent:
                continue
            hit = self._try_candidates(state, int(slot), cands, scores[i], consistent)
            if hit is not None:
                triggers.append((int(slot), *hit))
        return triggers

    def detect_join(self, state: MapState, kf_before: int, kf_reloc: int):
        """Sim3 of a candidate pair found by relocalization (see
        `SlamSystem._join_after_relocalization`): the keyframe tracking was
        lost from and the one it relocalized on. Returns S12 when both are
        live, share no map point (covisibility 0) and the Sim3 is accepted,
        else None. Read-only on `state`."""
        valid, row = sync.host_numpy(state.kf_valid, state.covis[kf_before])
        if not (valid[kf_before] and valid[kf_reloc]) or row[kf_reloc] > 0:
            return None
        success, S12, _, _ = compute_sim3(
            state, kf_before, kf_reloc, self.K, prng.key(kf_before * 131 + kf_reloc),
            fix_scale=self.fix_scale, voc=self.vocab,
        )
        return S12 if sync.host(success) else None

    def apply_closure(self, state: MapState, kf_id: int, cand: int, S12) -> MapState:
        """Mutating half (CorrectLoop): essential-graph correction, loop
        fusion over the full corrected group and all loop-side points,
        covisibility refresh, GBA (detached or inline). Safe on a live state
        even when the Sim3 was accepted on an earlier snapshot: S12 is a
        relative measurement between two keyframe frames."""
        state = correct_loop(state, kf_id, cand, S12)
        fuse_kfs, mp_cap = _fuse_caps(state, kf_id, cand)
        state, _ = search_and_fuse(state, kf_id, cand, self.K, fuse_kfs=fuse_kfs, mp_cap=mp_cap)
        state = refresh_covis(state)
        if self.detached_gba:
            # GBA runs detached on a post-correction snapshot; the caller
            # starts, aborts and merges it via service_gba.
            self._gba_pending = True
        else:
            state, _ = run_global_bundle_adjustment(state, self.K, self.bf, mesh=self.mesh)
        self.last_loop_seq = self.kf_counter
        self.n_loops_closed += 1
        self.closures.append((self.kf_counter, int(kf_id), int(cand)))
        self.consistency = LoopConsistency()
        return state

    def on_keyframe(self, state: MapState, kf_id: int, n_kf: int):
        """One synchronous LoopClosing round for a freshly inserted keyframe.
        Returns (state, loop_closed); the BoW database is replaced on
        `self.db`."""
        trig = self.detect_loop(state, kf_id, n_kf)
        if trig is None:
            return state, False
        cand, S12 = trig
        return self.apply_closure(state, kf_id, cand, S12), True
