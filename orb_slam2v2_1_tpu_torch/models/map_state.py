"""The map as struct-of-arrays state: keyframes, map points, observations.

Port of the JAX package's `models/map_state.py`. `MapState` has the
reference's field names and shapes; descriptors are (.., 8) int32 words
(see ops/hamming.py). Updates are out-of-place: every function returns a new
`MapState` and leaves its input untouched, as the reference's pure
functions do, so a caller may keep and reuse a snapshot.

`from_numpy` / `to_numpy` carry a map across from (and back to) the
reference's numpy layout, converting uint32 descriptors to int32 words.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..ops import hamming
from ..ops.topk import scatter_last, set_drop, stable_topk


class MapState(NamedTuple):
    # --- keyframes (capacity K, feature slots N) ---
    kf_pose: torch.Tensor  # (K,4,4) f32 Tcw
    kf_valid: torch.Tensor  # (K,) bool
    kf_frame_id: torch.Tensor  # (K,) i32
    kf_xy: torch.Tensor  # (K,N,2) f32
    kf_level: torch.Tensor  # (K,N) i32
    kf_angle: torch.Tensor  # (K,N) f32
    kf_desc: torch.Tensor  # (K,N,8) i32 descriptor words
    kf_kp_valid: torch.Tensor  # (K,N) bool
    kf_ur: torch.Tensor  # (K,N) f32 stereo right-u (-1 mono)
    kf_mp: torch.Tensor  # (K,N) i32 keypoint -> map point id (-1 none)
    kf_parent: torch.Tensor  # (K,) i32 spanning-tree parent (-1 root)
    kf_seq: torch.Tensor  # (K,) i32 insertion sequence (-1 unused)
    # --- map points (capacity M) ---
    mp_pos: torch.Tensor  # (M,3) f32
    mp_valid: torch.Tensor  # (M,) bool
    mp_desc: torch.Tensor  # (M,8) i32
    mp_normal: torch.Tensor  # (M,3) f32
    mp_min_dist: torch.Tensor  # (M,) f32
    mp_max_dist: torch.Tensor  # (M,) f32
    mp_visible: torch.Tensor  # (M,) i32
    mp_found: torch.Tensor  # (M,) i32
    mp_first_kf: torch.Tensor  # (M,) i32
    mp_first_seq: torch.Tensor  # (M,) i32
    loop_edges: torch.Tensor  # (LOOP_EDGE_CAP, 2) i32 (-1 unused)
    n_loop_edges: torch.Tensor  # () i32
    covis: torch.Tensor  # (K,K) i32 cached covisibility
    n_kf: torch.Tensor  # () i32 keyframe slot high-water mark
    n_mp: torch.Tensor  # () i32 map-point slot high-water mark
    n_seq: torch.Tensor  # () i32 keyframes ever inserted

    @property
    def max_kf(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def max_mp(self) -> int:
        return self.mp_pos.shape[0]

    @property
    def n_kp(self) -> int:
        return self.kf_xy.shape[1]


LOOP_EDGE_CAP = 32
OBS_CAP = 12  # max observations considered per point for stats

_DESC_FIELDS = ("kf_desc", "mp_desc")


def empty_map(max_kf: int = 256, max_mp: int = 32768, n_kp: int = 1024, device=None) -> MapState:
    """An empty map on `device` (None: the card, see `device.resolve`)."""
    device = device_mod.resolve(device)
    K, M, N = max_kf, max_mp, n_kp
    i32, f32 = torch.int32, torch.float32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return MapState(
        kf_pose=torch.eye(4, dtype=f32, device=device).repeat(K, 1, 1),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i32),
        kf_xy=full((K, N, 2), 0.0, f32),
        kf_level=full((K, N), 0, i32),
        kf_angle=full((K, N), 0.0, f32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_kp_valid=full((K, N), False, torch.bool),
        kf_ur=full((K, N), -1.0, f32),
        kf_mp=full((K, N), -1, i32),
        kf_parent=full((K,), -1, i32),
        kf_seq=full((K,), -1, i32),
        mp_pos=full((M, 3), 0.0, f32),
        mp_valid=full((M,), False, torch.bool),
        mp_desc=full((M, 8), 0, i32),
        mp_normal=full((M, 3), 0.0, f32),
        mp_min_dist=full((M,), 0.0, f32),
        mp_max_dist=full((M,), float("inf"), f32),
        mp_visible=full((M,), 1, i32),
        mp_found=full((M,), 1, i32),
        mp_first_kf=full((M,), -1, i32),
        mp_first_seq=full((M,), 0, i32),
        loop_edges=full((LOOP_EDGE_CAP, 2), -1, i32),
        n_loop_edges=full((), 0, i32),
        covis=full((K, K), 0, i32),
        n_kf=full((), 0, i32),
        n_mp=full((), 0, i32),
        n_seq=full((), 0, i32),
    )


def from_numpy(arrays: dict, device=None) -> MapState:
    """MapState on `device` (None: the card) from the reference's numpy arrays
    (uint32 descriptors become int32 words with the same bits)."""
    device = device_mod.resolve(device)
    out = {}
    for name in MapState._fields:
        a = np.asarray(arrays[name])
        if name in _DESC_FIELDS:
            a = hamming.words_from_uint32(a)
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return MapState(**out)


def to_numpy(state: MapState) -> dict:
    """The reference's numpy layout of `state` (uint32 descriptors)."""
    out = {}
    for name, t in zip(MapState._fields, state):
        out[name] = hamming.words_to_uint32(t) if name in _DESC_FIELDS else t.detach().cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# Derived graph structure
# ---------------------------------------------------------------------------


def _mark(n: int, idx: torch.Tensor, device) -> torch.Tensor:
    """(n,) bool with True at idx (all writes carry the same value)."""
    out = torch.zeros(n, dtype=torch.bool, device=device)
    out[idx.reshape(-1).long()] = True
    return out


def covisibility(state: MapState) -> torch.Tensor:
    """(K, K) int32 — map points shared by each keyframe pair, diagonal 0."""
    K, N = state.kf_mp.shape
    M = state.max_mp
    dev = state.kf_mp.device
    mp = torch.where(state.kf_kp_valid & (state.kf_mp >= 0), state.kf_mp, M).long()
    inc = torch.zeros((K, M + 1), dtype=torch.float32, device=dev)
    inc[torch.arange(K, device=dev)[:, None], mp] = 1.0
    inc = inc[:, :M] * state.mp_valid[None, :].to(torch.float32)
    C = (inc @ inc.T).to(torch.int32)
    C = C * (state.kf_valid[:, None] & state.kf_valid[None, :])
    return C * (1 - torch.eye(K, dtype=torch.int32, device=dev))


def row_covisibility(state: MapState, kf) -> torch.Tensor:
    """(K,) int32 — shared-point counts between keyframe `kf` and every
    keyframe, computed fresh in O(K*N)."""
    M = state.max_mp
    row = state.kf_mp[kf]
    row_ok = (row >= 0) & state.kf_kp_valid[kf]
    in_row = _mark(M + 1, torch.where(row_ok, row, M), row.device)[:M] & state.mp_valid
    shared = in_row[torch.clamp(state.kf_mp, min=0).long()] & (state.kf_mp >= 0) & state.kf_kp_valid
    votes = torch.sum(shared, dim=1, dtype=torch.int32) * state.kf_valid
    votes = votes.clone()
    votes[kf] = 0
    return votes * state.kf_valid[kf]


def refresh_covis(state: MapState) -> MapState:
    return state._replace(covis=covisibility(state))


def mp_observation_count(state: MapState) -> torch.Tensor:
    """(M,) int32 — keyframes observing each map point."""
    M = state.max_mp
    mp = torch.where(state.kf_kp_valid & (state.kf_mp >= 0) & state.kf_valid[:, None], state.kf_mp, M)
    counts = torch.zeros(M + 1, dtype=torch.int32, device=mp.device)
    counts = counts.index_add(0, mp.reshape(-1).long(), torch.ones(mp.numel(), dtype=torch.int32, device=mp.device))
    return counts[:M] * state.mp_valid


def _set_row(x: torch.Tensor, k, v) -> torch.Tensor:
    x = x.clone()
    x[k] = v
    return x


def append_keyframe(state: MapState, pose, frame_id, xy, level, angle, desc, kp_valid, ur, mp_ids):
    """Insert a keyframe at the first free slot and attach it to the spanning
    tree (parent = the keyframe sharing the most map points). Returns
    (state, kf_id) with kf_id a 0-dim int64 tensor."""
    k = torch.argmin(state.kf_valid.to(torch.int32))
    M = state.max_mp
    in_new = _mark(M + 1, torch.where((mp_ids >= 0) & kp_valid, mp_ids, M), mp_ids.device)[:M] & state.mp_valid
    shared = in_new[torch.clamp(state.kf_mp, min=0).long()] & (state.kf_mp >= 0) & state.kf_kp_valid
    votes = torch.sum(shared, dim=1, dtype=torch.int32) * state.kf_valid
    parent = torch.argmax(votes)
    parent = torch.where(votes[parent] > 0, parent, -1).to(torch.int32)
    state = state._replace(
        kf_pose=_set_row(state.kf_pose, k, pose),
        kf_valid=_set_row(state.kf_valid, k, True),
        kf_frame_id=_set_row(state.kf_frame_id, k, frame_id),
        kf_xy=_set_row(state.kf_xy, k, xy),
        kf_level=_set_row(state.kf_level, k, level),
        kf_angle=_set_row(state.kf_angle, k, angle),
        kf_desc=_set_row(state.kf_desc, k, desc),
        kf_kp_valid=_set_row(state.kf_kp_valid, k, kp_valid),
        kf_ur=_set_row(state.kf_ur, k, ur),
        kf_mp=_set_row(state.kf_mp, k, mp_ids),
        kf_parent=_set_row(state.kf_parent, k, parent),
        kf_seq=_set_row(state.kf_seq, k, state.n_seq),
        n_kf=torch.maximum(state.n_kf, (k + 1).to(torch.int32)),
        n_seq=state.n_seq + 1,
    )
    return state, k


def _desc_stats(descs, obs_ok):
    """Representative descriptor per point: min mean Hamming distance to the
    point's other observations. descs (P, J, 8), obs_ok (P, J) -> rep (P,)."""
    P, J = obs_ok.shape
    pm1 = hamming.unpack_pm1(descs.reshape(-1, 8)).reshape(P, J, 256)
    D = (256.0 - torch.einsum("mac,mbc->mab", pm1, pm1)) * 0.5
    pair_ok = obs_ok[:, :, None] & obs_ok[:, None, :]
    mean_d = torch.sum(torch.where(pair_ok, D, torch.zeros_like(D)), dim=-1) / torch.clamp(
        torch.sum(pair_ok, dim=-1), min=1
    )
    mean_d = torch.where(obs_ok, mean_d, torch.full_like(mean_d, float("inf")))
    return torch.argmin(mean_d, dim=-1)


def _mean_normal(pos, centers, obs_ok):
    vec = pos[:, None, :] - centers
    vec = vec / torch.clamp(torch.linalg.norm(vec, dim=-1, keepdim=True), min=1e-9)
    normal = torch.sum(torch.where(obs_ok[..., None], vec, torch.zeros_like(vec)), dim=1)
    n_obs = torch.clamp(torch.sum(obs_ok, dim=-1), min=1)
    normal = normal / n_obs[:, None]
    return normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-9)


def _cam_centers(poses):
    """World camera centers -R^T t of (K,4,4) poses."""
    return -torch.einsum("kij,ki->kj", poses[:, :3, :3], poses[:, :3, 3])


def update_mp_stats(state: MapState, scale: float = 1.2) -> MapState:
    """Recompute distinctive descriptors, normals and scale bands for all
    valid map points from up to OBS_CAP observations each."""
    K, N = state.kf_mp.shape
    M = state.max_mp
    dev = state.kf_mp.device
    flat_mp = torch.where(state.kf_kp_valid & state.kf_valid[:, None], state.kf_mp, -1).reshape(-1)
    key = torch.where(flat_mp >= 0, flat_mp, M).to(torch.int32)
    order = torch.argsort(key, stable=True)
    sorted_mp = key[order]
    ar = torch.arange(M, dtype=torch.int32, device=dev)
    seg_start = torch.searchsorted(sorted_mp, ar)
    obs_idx = torch.clamp(seg_start[:, None] + torch.arange(OBS_CAP, device=dev)[None, :], 0, K * N - 1)
    obs_flat = order[obs_idx]
    obs_ok = sorted_mp[obs_idx] == ar[:, None]
    obs_kf = obs_flat // N
    obs_slot = obs_flat % N

    descs = state.kf_desc[obs_kf, obs_slot]
    rep = _desc_stats(descs, obs_ok)
    arM = torch.arange(M, device=dev)
    new_desc = descs[arM, rep]
    any_obs = torch.any(obs_ok, dim=-1)
    mp_desc = torch.where(any_obs[:, None], new_desc, state.mp_desc)

    Twc_t = _cam_centers(state.kf_pose)
    normal = _mean_normal(state.mp_pos, Twc_t[obs_kf], obs_ok)
    mp_normal = torch.where(any_obs[:, None], normal, state.mp_normal)

    ref_kf = obs_kf[arM, rep]
    ref_slot = obs_slot[arM, rep]
    dist = torch.linalg.norm(state.mp_pos - Twc_t[ref_kf], dim=-1)
    ref_level = state.kf_level[ref_kf, ref_slot]
    max_dist = dist * torch.pow(scale, ref_level.to(torch.float32))
    min_dist = max_dist / scale**7.0
    return state._replace(
        mp_desc=mp_desc,
        mp_normal=mp_normal,
        mp_max_dist=torch.where(any_obs, max_dist * 1.2, state.mp_max_dist),
        mp_min_dist=torch.where(any_obs, min_dist * 0.8, state.mp_min_dist),
    )


def update_mp_stats_window(state: MapState, kf_id, scale: float = 1.2) -> MapState:
    """Refresh stats for only the points observed by keyframe `kf_id`, over
    its OBS_CAP best covisible keyframes."""
    K, N = state.kf_mp.shape
    M = state.max_mp
    J = min(OBS_CAP, K)
    dev = state.kf_mp.device

    row_w = row_covisibility(state, kf_id).clone()
    row_w[kf_id] = 1 << 20
    _, obs_kfs = stable_topk(torch.where(state.kf_valid, row_w, -1), J)

    rows_mp = state.kf_mp[obs_kfs]
    rows_ok = state.kf_kp_valid[obs_kfs] & (rows_mp >= 0) & state.kf_valid[obs_kfs][:, None]
    j_iota = torch.arange(J, device=dev)[:, None].expand(J, N)
    slot_iota = torch.arange(N, dtype=torch.int32, device=dev)[None, :].expand(J, N)
    # A point held twice in one row keeps its later slot (XLA's in-order scatter).
    inv = scatter_last(
        torch.full((J * (M + 1),), N, dtype=torch.int32, device=dev),
        j_iota * (M + 1) + torch.where(rows_ok, rows_mp, M).long(), slot_iota,
    ).reshape(J, M + 1)

    sub = state.kf_mp[kf_id]
    subc = torch.clamp(sub, min=0).long()
    sub_ok = (sub >= 0) & state.kf_kp_valid[kf_id] & state.mp_valid[subc]
    obs_slot = inv[:, :M][torch.arange(J, device=dev)[:, None], subc[None, :]].T  # (N,J)
    obs_ok = (obs_slot < N) & sub_ok[:, None]
    obs_kf = obs_kfs[None, :].expand(N, J)
    obs_slot_c = torch.clamp(obs_slot, max=N - 1).long()

    descs = state.kf_desc[obs_kf, obs_slot_c]
    rep = _desc_stats(descs, obs_ok)
    arN = torch.arange(N, device=dev)
    new_desc = descs[arN, rep]
    any_obs = torch.any(obs_ok, dim=-1)

    Twc_t = _cam_centers(state.kf_pose[obs_kfs])
    pos = state.mp_pos[subc]
    new_normal = _mean_normal(pos, Twc_t[None, :, :], obs_ok)

    dist = torch.linalg.norm(pos - Twc_t[rep], dim=-1)
    ref_level = state.kf_level[obs_kfs[rep], obs_slot_c[arN, rep]]
    max_dist = dist * torch.pow(scale, ref_level.to(torch.float32))
    min_dist = max_dist / scale**7.0

    tgt = torch.where(any_obs & sub_ok, sub, M).long()
    return state._replace(
        mp_desc=set_drop(state.mp_desc, tgt, new_desc),
        mp_normal=set_drop(state.mp_normal, tgt, new_normal),
        mp_max_dist=set_drop(state.mp_max_dist, tgt, max_dist * 1.2),
        mp_min_dist=set_drop(state.mp_min_dist, tgt, min_dist * 0.8),
    )
