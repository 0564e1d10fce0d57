"""Multi-session map server: delta streaming, per-client maps, map merge.

Port of the JAX package's `parallel/server.py` (the reference's ROS
client/server layer: `SendClassToServer`, src/StreamThread.cc, becomes a
client-side delta log; the `Communicator` / `ServerMap` node,
src/ros_server.cc and src/ServerMap.cc, becomes `SlamServer` holding one map
per client; the `CLIENT_MAP<cid>` broadcast becomes `merge_clients` and a
map the client loads).

The wire format is the reference's: one compressed npz per delta, with its
field names and dtypes (uint32 descriptors), so a delta encoded by either
package decodes in the other's server. The server's maps live on its device
(None: the card) and the merge runs there; only the bytes on the wire are
numpy. Commands are the reference's INSERT=0, ERASE=1, UPDATE=2
(src/ros_server.cc:20-22).
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .. import device as device_mod
from .. import sync
from ..models.map_state import MapState, empty_map, refresh_covis
from ..ops import hamming

INSERT, ERASE, UPDATE = 0, 1, 2


# ---------------------------------------------------------------------------
# Delta encoding (the KF.msg / MP.msg analog)
# ---------------------------------------------------------------------------


def encode_keyframe_delta(state: MapState, kf_id: int, command: int = INSERT) -> bytes:
    """One keyframe and the points it observes (RunKeyFrame,
    src/StreamThread.cc:50-137), with the points' viewing normal and
    scale-invariance band, which the server's merge fusion needs. The rows
    are gathered on the device and read in one counted transfer."""
    kf = int(kf_id)
    mp_ids = state.kf_mp[kf]
    observed = torch.unique(mp_ids[mp_ids >= 0]).long()
    (frame_id, parent, seq, pose, xy, level, angle, desc, kp_valid, ur, kf_mp, obs, mp_pos, mp_desc, mp_normal,
     mp_min, mp_max) = sync.host_numpy(
        state.kf_frame_id[kf], state.kf_parent[kf], state.kf_seq[kf], state.kf_pose[kf], state.kf_xy[kf],
        state.kf_level[kf], state.kf_angle[kf], state.kf_desc[kf], state.kf_kp_valid[kf], state.kf_ur[kf], mp_ids,
        observed.to(torch.int32), state.mp_pos[observed], state.mp_desc[observed], state.mp_normal[observed],
        state.mp_min_dist[observed], state.mp_max_dist[observed])
    buf = io.BytesIO()
    np.savez_compressed(
        buf,
        command=np.int32(command), kf_id=np.int32(kf), frame_id=frame_id, parent=parent, seq=seq, pose=pose,
        xy=xy, level=level, angle=angle, desc=desc.view(np.uint32), kp_valid=kp_valid, ur=ur, kf_mp=kf_mp,
        mp_ids=obs, mp_pos=mp_pos, mp_desc=mp_desc.view(np.uint32), mp_normal=mp_normal, mp_min_dist=mp_min,
        mp_max_dist=mp_max,
    )
    return buf.getvalue()


def encode_pose_update(state: MapState, kf_ids) -> bytes:
    """Refined keyframe poses and every valid point's position after BA or a
    loop correction (the UPDATE path, src/StreamThread.cc:225-236)."""
    ids = torch.as_tensor(np.asarray(kf_ids, np.int64), device=state.kf_pose.device)
    valid = torch.nonzero(state.mp_valid)[:, 0]
    poses, mp_ids, mp_pos = sync.host_numpy(state.kf_pose[ids], valid.to(torch.int32), state.mp_pos[valid])
    buf = io.BytesIO()
    np.savez_compressed(buf, command=np.int32(UPDATE), kf_ids=np.asarray(kf_ids, np.int32), poses=poses,
                        mp_ids=mp_ids, mp_pos=mp_pos)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


@dataclass
class ClientMap:
    """The server's mirror of one client's map (the ServerMap analog)."""

    max_kf: int
    max_mp: int
    n_kp: int
    device: object = None
    state: MapState = None
    n_deltas: int = 0

    def __post_init__(self):
        if self.state is None:
            self.state = empty_map(self.max_kf, self.max_mp, self.n_kp, device=self.device)


def _bow_rows(state: MapState, voc) -> torch.Tensor:
    """The tf-idf BoW vector of every keyframe slot, (K, W): the server's
    BoW database for cross-session retrieval."""
    from ..ops import vocab as vocab_ops

    words = vocab_ops.assign_words(voc, state.kf_desc)
    return vocab_ops.bow_vector(words, state.kf_kp_valid, voc.word_weight, voc.word_weight.shape[0])


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)


def _set_rows(x: torch.Tensor, idx, v) -> torch.Tensor:
    """A copy of x with rows idx set to v."""
    out = x.clone()
    out[idx] = v
    return out


class SlamServer:
    """The central map server (the ros_server Communicator analog), its maps
    on `device` (None: the card)."""

    def __init__(self, max_kf: int = 256, max_mp: int = 32768, n_kp: int = 1024, device=None):
        self.device = device_mod.resolve(device)
        self.clients: dict[int, ClientMap] = {}
        self.dims = (max_kf, max_mp, n_kp)
        self.last_merge_fused = 0
        self.last_merge_inliers = 0

    def _client(self, cid: int) -> ClientMap:
        if cid not in self.clients:
            self.clients[cid] = ClientMap(*self.dims, device=self.device)
        return self.clients[cid]

    def receive(self, cid: int, delta: bytes):
        """Apply one delta to the client's map (Communicator::KeyFrameData /
        MapPointData, src/ros_server.cc:48-102)."""
        data = np.load(io.BytesIO(delta))
        cm = self._client(cid)
        cmd = int(data["command"])
        if cmd == INSERT:
            self._apply_insert(cm, data)
        elif cmd == UPDATE:
            self._apply_update(cm, data)
        elif cmd == ERASE:
            cm.state = cm.state._replace(kf_valid=_set_rows(cm.state.kf_valid, int(data["kf_id"]), False))
        cm.n_deltas += 1

    def _apply_insert(self, cm: ClientMap, data):
        st = cm.state
        dev = self.device
        kf = int(data["kf_id"])
        mp_ids = data["mp_ids"].astype(np.int64)
        idx = _t(mp_ids, dev)
        upd = {}
        if len(mp_ids):
            # Points first, so the keyframe's kf_mp references resolve.
            upd = dict(
                mp_pos=_set_rows(st.mp_pos, idx, _t(data["mp_pos"], dev)),
                mp_valid=_set_rows(st.mp_valid, idx, True),
                mp_desc=_set_rows(st.mp_desc, idx, _t(hamming.words_from_uint32(data["mp_desc"]), dev)),
            )
            if "mp_min_dist" in data.files:
                upd.update(
                    mp_min_dist=_set_rows(st.mp_min_dist, idx, _t(data["mp_min_dist"], dev)),
                    mp_max_dist=_set_rows(st.mp_max_dist, idx, _t(data["mp_max_dist"], dev)),
                    mp_normal=_set_rows(st.mp_normal, idx, _t(data["mp_normal"], dev)),
                )
        seq = int(data["seq"]) if "seq" in data.files else kf
        parent = int(data["parent"]) if "parent" in data.files else -1
        i32 = torch.int32
        n_mp = torch.maximum(st.n_mp, torch.tensor(int(mp_ids.max()) + 1, dtype=i32, device=dev)) \
            if len(mp_ids) else st.n_mp
        cm.state = st._replace(
            **upd,
            kf_pose=_set_rows(st.kf_pose, kf, _t(data["pose"], dev)),
            kf_valid=_set_rows(st.kf_valid, kf, True),
            kf_frame_id=_set_rows(st.kf_frame_id, kf, int(data["frame_id"])),
            kf_xy=_set_rows(st.kf_xy, kf, _t(data["xy"], dev)),
            kf_level=_set_rows(st.kf_level, kf, _t(data["level"], dev)),
            kf_angle=_set_rows(st.kf_angle, kf, _t(data["angle"], dev)),
            kf_desc=_set_rows(st.kf_desc, kf, _t(hamming.words_from_uint32(data["desc"]), dev)),
            kf_kp_valid=_set_rows(st.kf_kp_valid, kf, _t(data["kp_valid"], dev)),
            kf_ur=_set_rows(st.kf_ur, kf, _t(data["ur"], dev)),
            kf_mp=_set_rows(st.kf_mp, kf, _t(data["kf_mp"], dev)),
            kf_parent=_set_rows(st.kf_parent, kf, parent),
            kf_seq=_set_rows(st.kf_seq, kf, seq),
            n_seq=torch.maximum(st.n_seq, torch.tensor(seq + 1, dtype=i32, device=dev)),
            n_kf=torch.maximum(st.n_kf, torch.tensor(kf + 1, dtype=i32, device=dev)),
            n_mp=n_mp,
        )

    def _apply_update(self, cm: ClientMap, data):
        st = cm.state
        dev = self.device
        cm.state = st._replace(
            kf_pose=_set_rows(st.kf_pose, _t(data["kf_ids"].astype(np.int64), dev), _t(data["poses"], dev)),
            mp_pos=_set_rows(st.mp_pos, _t(data["mp_ids"].astype(np.int64), dev), _t(data["mp_pos"], dev)),
        )

    # ------------------------------------------------------------------
    def client_map(self, cid: int) -> MapState:
        return self._client(cid).state

    def _get_vocab(self):
        """The package's vocabulary, `models.system.VOCAB_NPZ` (None when
        the file is missing)."""
        if not hasattr(self, "_vocab"):
            from ..models.system import VOCAB_NPZ
            from ..ops import vocab as vocab_ops

            self._vocab = (vocab_ops.load_vocabulary(np.load(VOCAB_NPZ), device=self.device)
                           if os.path.exists(VOCAB_NPZ) else None)
        return self._vocab

    def merge_clients(self, cid_a: int, cid_b: int, K, key: tuple[int, int] | None = None, vocab=None,
                      top_pairs: int = 5, joint_optimize: bool = True,
                      sim3_sets: Callable[[torch.Tensor], torch.Tensor] | None = None) -> Optional[MapState]:
        """Merge client B's map into client A's world (the operator's
        `SendMap` merge, src/ros_server.cc:119-168), at loop-closing quality:

        1. rank keyframe pairs by tf-idf BoW similarity, one (Ka, W) x (W, Kb)
           product;
        2. match descriptors and run the Horn Sim3 RANSAC on the best pairs,
           accepting the first with >= 20 inliers;
        3. align B rigidly into A's world and concatenate (capacity-guarded);
        4. treat the seam as CorrectLoop does: the seam edge, the
           essential-graph optimization and SearchAndFuse's duplicate merge
           (src/LoopClosing.cc:453-622).

        The RANSAC draws every pair's hypothesis sets from the one `key`
        (default `prng.key(0)`), as the reference does; or `sim3_sets(valid)`
        gives them. Returns the merged map, or None."""
        from ..models import loop_closing as lc
        from ..ops import lie, matching, prng, sim3solver

        self.last_merge_fused = self.last_merge_inliers = 0
        a = self._client(cid_a).state
        b = self._client(cid_b).state
        n_a, n_b = (int(x) for x in sync.host(torch.stack([a.n_kf, b.n_kf])))
        if n_a == 0 or n_b == 0:
            return None
        dev = self.device
        K = torch.as_tensor(K, dtype=torch.float32).to(dev)
        if key is None:
            key = prng.key(0)

        # --- 1. BoW candidate ranking (one product on the host, as the reference) ---
        vocab = vocab or self._get_vocab()
        pairs = []
        if vocab is not None:
            Va, Vb, va_ok, vb_ok = sync.host_numpy(_bow_rows(a, vocab), _bow_rows(b, vocab), a.kf_valid, b.kf_valid)
            S = Va @ Vb.T
            S = np.where(va_ok[:, None] & vb_ok[None, :], S, -1.0)
            flat = np.argsort(-S.reshape(-1))[:top_pairs]
            pairs = [(int(i // S.shape[1]), int(i % S.shape[1])) for i in flat if S.reshape(-1)[i] > 0]
        if not pairs:  # no vocabulary: the first keyframes of each
            pairs = [(ka, kb) for ka in range(min(n_a, 3)) for kb in range(min(n_b, 3))][:top_pairs]

        # --- 2. Sim3 on the ranked pairs ---
        accepted = None
        for ka, kb in pairs:
            m = matching.match_nn(
                hamming.unpack_pm1(a.kf_desc[ka]), hamming.unpack_pm1(b.kf_desc[kb]),
                (a.kf_kp_valid[ka] & (a.kf_mp[ka] >= 0))[:, None] & (b.kf_kp_valid[kb] & (b.kf_mp[kb] >= 0))[None, :],
                max_dist=matching.TH_LOW, nn_ratio=0.75,
            )
            if sync.host(torch.sum(m.ok)) < 20:
                continue
            pose_a, pose_b = a.kf_pose[ka], b.kf_pose[kb]
            mp_a = torch.clamp(a.kf_mp[ka], min=0).long()
            mp_b = torch.clamp(b.kf_mp[kb][m.idx], min=0).long()
            p1 = a.mp_pos[mp_a] @ pose_a[:3, :3].T + pose_a[:3, 3]
            p2 = b.mp_pos[mp_b] @ pose_b[:3, :3].T + pose_b[:3, 3]
            ones = torch.ones(p1.shape[0], dtype=torch.float32, device=dev)
            sets = sim3solver.hypothesis_sets(m.ok, key) if sim3_sets is None else sim3_sets(m.ok)
            res = sim3solver.sim3_ransac(p1, p2, a.kf_xy[ka], b.kf_xy[kb][m.idx], ones, ones, m.ok, K,
                                         sets=sets, fix_scale=True)
            ok, n_inl = sync.host(torch.stack([res.success.to(torch.int32), res.n_inliers]))
            if ok and n_inl >= 20:
                accepted = (ka, kb, res.S12)
                self.last_merge_inliers = int(n_inl)
                break
        if accepted is None:
            return None
        ka, kb, S12 = accepted

        # --- 3. rigid-align B into A's world and concatenate ---
        T_ab = lie.sim3_inverse(a.kf_pose[ka]) @ S12 @ b.kf_pose[kb]
        merged = self._concat(a, b, T_ab)  # raises on a capacity overflow

        # --- 4. seam edge, essential graph, duplicate fusion ---
        if joint_optimize:
            kb_new = n_a + kb
            # B's keyframe is the "current" side, A's the fixed "loop" side:
            # the essential graph anchors A's world and A's landmarks win the
            # fusion. After the rigid alignment the seam measurement is the
            # live relative pose.
            S_seam = merged.kf_pose[kb_new] @ torch.linalg.inv(merged.kf_pose[ka])
            merged = lc.correct_loop(merged, kb_new, ka, S_seam)
            fuse_kfs, mp_cap = lc._fuse_caps(merged, kb_new, ka)
            merged, n_fused = lc.search_and_fuse(merged, kb_new, ka, K, fuse_kfs=fuse_kfs, mp_cap=mp_cap)
            merged = refresh_covis(merged)
            self.last_merge_fused = int(sync.host(n_fused))
        return merged

    @staticmethod
    def _concat(a: MapState, b: MapState, T_ab: torch.Tensor) -> MapState:
        """A and B in one map, B moved by T_ab into A's world. Raises
        ValueError when they exceed A's capacity: a silent truncation would
        drop keyframes and points without trace."""
        from ..ops import lie

        n_kf_a, n_kf_b, n_mp_a, n_mp_b, n_seq_a, n_seq_b, n_le_a, n_le_b = (int(x) for x in sync.host(torch.stack(
            [a.n_kf, b.n_kf, a.n_mp, b.n_mp, a.n_seq, b.n_seq, a.n_loop_edges, b.n_loop_edges])))
        Kcap, Mcap = a.max_kf, a.max_mp
        if n_kf_a + n_kf_b > Kcap or n_mp_a + n_mp_b > Mcap:
            raise ValueError(
                f"merge exceeds capacity: {n_kf_a}+{n_kf_b} keyframes vs {Kcap}, {n_mp_a}+{n_mp_b} points vs "
                f"{Mcap}; grow the server map capacity or cull before merging"
            )
        T_ab = T_ab.to(a.kf_pose.device)
        T_ba = lie.se3_inverse(T_ab)
        mp = slice(n_mp_a, n_mp_a + n_mp_b)
        kf = slice(n_kf_a, n_kf_a + n_kf_b)
        put = _set_rows

        # B's points into A's world: positions and viewing normals rotate;
        # the scale-invariance band is metric and T_ab rigid.
        R_ab = T_ab[:3, :3]
        st = a._replace(
            mp_pos=put(a.mp_pos, mp, b.mp_pos[:n_mp_b] @ R_ab.T + T_ab[:3, 3]),
            mp_valid=put(a.mp_valid, mp, b.mp_valid[:n_mp_b]),
            mp_desc=put(a.mp_desc, mp, b.mp_desc[:n_mp_b]),
            mp_normal=put(a.mp_normal, mp, b.mp_normal[:n_mp_b] @ R_ab.T),
            mp_min_dist=put(a.mp_min_dist, mp, b.mp_min_dist[:n_mp_b]),
            mp_max_dist=put(a.mp_max_dist, mp, b.mp_max_dist[:n_mp_b]),
            mp_visible=put(a.mp_visible, mp, b.mp_visible[:n_mp_b]),
            mp_found=put(a.mp_found, mp, b.mp_found[:n_mp_b]),
            mp_first_seq=put(a.mp_first_seq, mp, b.mp_first_seq[:n_mp_b] + n_seq_a),
            n_mp=torch.tensor(n_mp_a + n_mp_b, dtype=torch.int32, device=a.n_mp.device),
        )
        # B's keyframes: pose_new = pose_b @ T_ba; slots shift by n_kf_a, the
        # insertion sequence by A's count.
        bmp = b.kf_mp[:n_kf_b]
        par_b = b.kf_parent[:n_kf_b]
        seq_b = b.kf_seq[:n_kf_b]
        st = st._replace(
            kf_pose=put(a.kf_pose, kf, b.kf_pose[:n_kf_b] @ T_ba[None]),
            kf_valid=put(a.kf_valid, kf, b.kf_valid[:n_kf_b]),
            kf_frame_id=put(a.kf_frame_id, kf, b.kf_frame_id[:n_kf_b]),
            kf_xy=put(a.kf_xy, kf, b.kf_xy[:n_kf_b]),
            kf_level=put(a.kf_level, kf, b.kf_level[:n_kf_b]),
            kf_angle=put(a.kf_angle, kf, b.kf_angle[:n_kf_b]),
            kf_desc=put(a.kf_desc, kf, b.kf_desc[:n_kf_b]),
            kf_kp_valid=put(a.kf_kp_valid, kf, b.kf_kp_valid[:n_kf_b]),
            kf_ur=put(a.kf_ur, kf, b.kf_ur[:n_kf_b]),
            kf_mp=put(a.kf_mp, kf, torch.where(bmp >= 0, bmp + n_mp_a, -1)),
            kf_parent=put(a.kf_parent, kf, torch.where(par_b >= 0, par_b + n_kf_a, -1)),
            kf_seq=put(a.kf_seq, kf, torch.where(seq_b >= 0, seq_b + n_seq_a, -1)),
            n_kf=torch.tensor(n_kf_a + n_kf_b, dtype=torch.int32, device=a.n_kf.device),
        )
        # Loop edges of B (shifted) after A's, as far as the ring holds them.
        cap = a.loop_edges.shape[0]
        n_le_a, n_le_b = min(n_le_a, cap), min(n_le_b, cap)
        take = min(n_le_b, cap - n_le_a)
        le = a.loop_edges.clone()
        if take > 0:
            le_b = b.loop_edges[:take]
            le[n_le_a:n_le_a + take] = torch.where(le_b >= 0, le_b + n_kf_a, -1)
        st = st._replace(
            loop_edges=le,
            n_loop_edges=torch.tensor(n_le_a + take, dtype=torch.int32, device=a.n_kf.device),
            n_seq=torch.tensor(n_seq_a + n_seq_b, dtype=torch.int32, device=a.n_kf.device),
        )
        return refresh_covis(st)


class DeltaStream:
    """The client-side delta log (the SendClassToServer analog) for a server
    in the same process: keyframe insertions and a pose update per flush."""

    def __init__(self, server: SlamServer, cid: int):
        self.server = server
        self.cid = cid
        # Keyed by slot, holding the keyframe's insertion sequence: culled
        # slots are reused by new keyframes, so a slot alone is no identity.
        self._sent_kfs: dict[int, int] = {}

    def flush(self, state: MapState, n_kf: int):
        """Send the keyframes not sent yet (or whose slot was reused), then a
        pose and point update of every live sent keyframe."""
        kf_valid, kf_seq = sync.host_numpy(state.kf_valid[:n_kf], state.kf_seq[:n_kf])
        for k in range(n_kf):
            if kf_valid[k] and self._sent_kfs.get(k) != int(kf_seq[k]):
                self.server.receive(self.cid, encode_keyframe_delta(state, k, INSERT))
                self._sent_kfs[k] = int(kf_seq[k])
        live = [k for k in sorted(self._sent_kfs) if k < n_kf and kf_valid[k]]
        if live:
            self.server.receive(self.cid, encode_pose_update(state, np.asarray(live, np.int32)))
