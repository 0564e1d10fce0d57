#!/usr/bin/env python3
"""bench.py's online leg (chip_smoke.py phase 11) several times on one card.

    python3 tests/torch_online_repeat.py [--runs 3] [--out DIR] [--loop-log]
        [--events FILE] [--sim3-dump DIR] [--keep-stale] [--lba-dump DIR] [--fuse-gate]

Needs one NVIDIA card; run from the repository root. The worker threads'
timing decides which frame becomes a keyframe and when a mapping round or
the loop closure lands, so runs of the async + pipelined leg differ: this
runs `chip_smoke.run_online_async` --runs times on the same rendered orbit,
prints each run's line (phase 11's, none of its assertions applied, so a
run that would fail the phase is recorded and the next one starts), with
its loops, relocalizations and the decision vector of each lost frame, the
keypoints with a live map point in each keyframe of the final map, and
the spread of the run's estimated camera centers by segment of the orbit. The
orbit turns in place, so every true camera center coincides: a segment whose
mean center sits away from the first segment's was displaced. With --out,
each run's poses go to DIR/online_run<k>.npz and its map (`save_map`) to
DIR/online_map<k>.npz. With --loop-log each run also prints every loop
detection round: its insertion count and keyframe, the live keyframes, the
candidates, how many reached the 3-round consistency, and each Sim3 tried
(candidate, accepted, inliers, total support, BoW matches, RANSAC success,
RANSAC inliers), and, when none of the 3 strongest consistent candidates
was accepted, each weaker one the closer does not try, tried for the log
only ("untried": candidate, accepted, inliers, total support). With --events each run appends one JSON
line to FILE: the keyframe centers (by insertion sequence) before and after
every loop closure and every global-BA merge, each local BA's window (free
and fixed keyframes, observations, cost, how far it moved each keyframe),
the snapshot each global BA
started from, every keyframe insertion (its frame, whether it was
re-anchored on a moved reference keyframe, its center), every decided frame
(the map version it was tracked on and the one it was decided on, its
center then) and the final keyframe centers, each with the tracker's frame
at the time. With --sim3-dump, each `compute_sim3` that fails on a
consistent candidate saves its map (the reference's npz format), the pair
and the card's hypothesis sets to DIR/sim3_run<k>_<n>.npz (the first two of a run), the input of
`tests/torch_sim3_probe.py`. --keep-stale appends each keyframe with its
frame's point ids as they are, as the reference does (the association filter
of `SlamSystem._insert_keyframe_async` off), for a before/after comparison
in one call. With --events, --lba-dump DIR saves the map before each local
BA that moved a keyframe more than 0.5 m (at most six in all), with its
window, for `tests/torch_lba_probe.py`. --fuse-gate adds ORB-SLAM2's chi2
gate to the fusion's matches, which neither package has, as a trial. Not a
test: pytest does not collect this file.
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEGMENTS = ((0, 120), (120, 240), (240, 260), (260, 300), (300, 321))


def main():
    args = sys.argv[1:]
    runs = int(args[args.index("--runs") + 1]) if "--runs" in args else 3
    out = args[args.index("--out") + 1] if "--out" in args else None
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_online_repeat: needs an NVIDIA card")
    import chip_smoke
    from orb_slam2v2_1_tpu_torch import kernel_times as kt
    from orb_slam2v2_1_tpu_torch import kernels
    from orb_slam2v2_1_tpu_torch.utils import config, synthetic

    rounds = []
    if "--loop-log" in args:
        from orb_slam2v2_1_tpu_torch import sync
        from orb_slam2v2_1_tpu_torch.models import loop_closing as lc
        from orb_slam2v2_1_tpu_torch.ops import prng

        detect, consistent, sim3 = lc.LoopCloser.detect_loop, lc.LoopCloser._consistent, lc.compute_sim3

        def logged_detect(self, state, kf_id, n_kf):
            rounds.append({"count": self.kf_counter + 1, "kf": int(kf_id), "n_kf": n_kf, "cands": None,
                           "consistent": None, "sim3": [], "untried": []})
            return detect(self, state, kf_id, n_kf)

        def logged_consistent(self, cands, C):
            out = consistent(self, cands, C)
            rounds[-1].update(cands=[int(c) for c in cands], consistent=[int(cands[g]) for g in out])
            return out

        def logged_sim3(state, kf_cur, kf_cand, *a, **k):
            tries.clear()
            out = sim3(state, kf_cur, kf_cand, *a, **k)
            if rounds:
                rounds[-1]["sim3"].append((int(kf_cand), bool(sync.host(out[0])), int(sync.host(out[2])),
                                           int(sync.host(out[3])), *tries))
            return out

        tries = []
        match_kf, ransac = lc.match_keyframes, lc.sim3solver.sim3_ransac

        def logged_match(*a, **k):
            m = match_kf(*a, **k)
            tries.append(int(sync.host(m.ok.sum())))
            return m

        def logged_ransac(*a, **k):
            res = ransac(*a, **k)
            tries.extend((bool(sync.host(res.success)), int(sync.host(res.n_inliers))))
            return res

        try_candidates = lc.LoopCloser._try_candidates

        def logged_try(self, state, kf_id, cands, scores, consistent):
            # The closer tries the 3 strongest consistent candidates; the
            # others are tried here too, for the log only.
            out = try_candidates(self, state, kf_id, cands, scores, consistent)
            rest = sorted(consistent, key=lambda gi: -scores[cands[gi]])[3:]
            if out is None and rest and rounds:
                for gi in rest:
                    c = int(cands[gi])
                    r = sim3(state, kf_id, c, self.K, prng.key(kf_id * 131 + c), fix_scale=self.fix_scale,
                             voc=self.vocab)
                    rounds[-1]["untried"].append((c, bool(sync.host(r[0])), int(sync.host(r[2])),
                                                  int(sync.host(r[3]))))
            return out

        lc.LoopCloser.detect_loop, lc.LoopCloser._consistent, lc.compute_sim3 = (logged_detect, logged_consistent,
                                                                                  logged_sim3)
        lc.LoopCloser._try_candidates = logged_try
        lc.match_keyframes, lc.sim3solver.sim3_ransac = logged_match, logged_ransac
    from orb_slam2v2_1_tpu_torch.models import system

    DUMP["filter"] = system._live_associations
    if "--keep-stale" in args:
        # The association filter of `SlamSystem._insert_keyframe_async` off:
        # the frame's ids are appended as they are (the reference's way).
        system._live_associations = lambda mp, snap, live: mp
    if "--fuse-gate" in args:
        _install_fuse_gate(config.SlamConfig(**kt.BENCH).bf)
    LBA_DUMP["dir"] = args[args.index("--lba-dump") + 1] if "--lba-dump" in args else None
    events = _install_event_log(args) if "--events" in args else None
    dump = args[args.index("--sim3-dump") + 1] if "--sim3-dump" in args else None
    if dump:
        _install_sim3_dump(dump)
    kernels.build()
    card = kt.card_line()
    cfg = config.SlamConfig(**kt.BENCH)
    imgs, deps, gt = synthetic.orbit_frames(cfg, chip_smoke.LOOP_FRAMES, total=kt.ORBIT_TOTAL)
    chip_smoke.ONLINE_ASYNC_ATE_BOUND = float("inf")
    for run in range(runs):
        rounds.clear()
        if events is not None:
            events.clear()
        DUMP["run"], DUMP["n"] = run, 0
        rec, _, slam, _ = chip_smoke.run_online_async(imgs, deps, gt, cfg, card, check=False)
        if "--loop-log" in args:
            print(json.dumps({"run": run, "loop_rounds": rounds}), flush=True)
        est = slam.trajectory.absolute_poses(slam.map.kf_pose.cpu().numpy())
        frames = np.array([round(t * chip_smoke.ASYNC_FPS) for t, _ in est])
        c = np.stack([T[:3, 3] for _, T in est])
        base = c[(frames >= SEGMENTS[0][0]) & (frames < SEGMENTS[0][1])].mean(0)
        seg = {}
        for a, b in SEGMENTS:
            m = (frames >= a) & (frames < b)
            mean = c[m].mean(0)
            seg[f"{a}-{b - 1}"] = {"offset_m": float(np.linalg.norm(mean - base)),
                                   "spread_m": float(np.linalg.norm(c[m] - mean, axis=1).mean())}
        print(json.dumps({"run": run, "ate_m": rec["ate_m"],
                          f"ate_first_{chip_smoke.ASYNC_PREFIX}_m": rec[f"ate_first_{chip_smoke.ASYNC_PREFIX}_m"],
                          "keyframes": rec["keyframes"], "fps": rec["fps"], "map_ms_p50": rec["map_ms_p50"],
                          "closures": slam.loop_closer.closures,
                          "loops_closed": slam.n_loops_closed, "relocalizations_at": rec["relocalizations_at"],
                          "losses": slam.losses, "kf_points": _kf_points(slam.map),
                          "segments": seg, "card": card}), flush=True)
        if events is not None:
            final = slam._settled_map()
            with open(args[args.index("--events") + 1], "a") as f:
                f.write(json.dumps({"run": run, "events": events, "final": _centers(final),
                                    "frames": [[int(fr), *c.round(4).tolist()] for fr, c in zip(frames, c)]}) + "\n")
        if out:
            os.makedirs(out, exist_ok=True)
            np.savez(os.path.join(out, f"online_run{run}.npz"), frames=frames,
                     Twc=np.stack([T for _, T in est]))
            slam.save_map(os.path.join(out, f"online_map{run}.npz"))


DUMP = {"run": 0, "n": 0}
# --lba-dump DIR: maps before the local BAs that moved a keyframe this far (m).
LBA_DUMP = {"dir": None, "min_move": 0.5, "n": 0, "cap": 6}
DUMP_CAP = 2  # failed Sim3s saved per run (a map is about 1.2 MB)


def _kf_points(state):
    """[insertion sequence, frame, keypoints with a live map point] of each
    live keyframe of the final map, in insertion order."""
    import numpy as np

    valid, seq, frame = (t.cpu().numpy() for t in (state.kf_valid, state.kf_seq, state.kf_frame_id))
    n = ((state.kf_mp >= 0) & state.kf_kp_valid).sum(1).cpu().numpy()
    return sorted([int(seq[k]), int(frame[k]), int(n[k])] for k in np.nonzero(valid)[0])


def _centers(state):
    """{insertion sequence: camera center} of the live keyframes."""
    import numpy as np

    pose, valid, seq = (t.cpu().numpy() for t in (state.kf_pose, state.kf_valid, state.kf_seq))
    out = {}
    for k in np.nonzero(valid)[0]:
        R, t = pose[k, :3, :3], pose[k, :3, 3]
        out[int(seq[k])] = (-R.T @ t).round(4).tolist()
    return out


def _install_event_log(args):
    """Wrap the closure, the global-BA start and merge, keyframe insertion
    and the frame decisions to record what each did to the map (see the
    module doc)."""
    import numpy as np

    from orb_slam2v2_1_tpu_torch import sync
    from orb_slam2v2_1_tpu_torch.models import loop_closing as lc
    from orb_slam2v2_1_tpu_torch.models import system

    events, live = [], {}
    start_async = system.SlamSystem._start_async

    def logged_start_async(self):
        live["slam"] = self
        return start_async(self)

    def frame_now():
        slam = live.get("slam")
        return None if slam is None else slam.frame_id

    apply_closure = lc.LoopCloser.apply_closure

    def logged_apply_closure(self, state, kf_id, cand, S12):
        before = _centers(state)
        out = apply_closure(self, state, kf_id, cand, S12)
        events.append({"type": "closure", "frame": frame_now(), "kf_seq": int(state.kf_seq[kf_id]),
                       "loop_seq": int(state.kf_seq[cand]), "before": before, "after": _centers(out)})
        return out

    merge = lc.LoopCloser._merge

    def logged_merge(self, box):
        res = self.gba_runner.result
        snap_seq, snap_valid = res[0].cpu().numpy(), res[1].cpu().numpy()
        before_state, _ = box.read()
        merge(self, box)
        after_state, _ = box.read()
        live_seq = before_state.kf_seq.cpu().numpy()
        same = [int(s) for s, v, ss, sv in zip(live_seq, before_state.kf_valid.cpu().numpy(), snap_seq, snap_valid)
                if v and sv and s == ss]
        events.append({"type": "merge", "frame": frame_now(), "same": same, "before": _centers(before_state),
                       "after": _centers(after_state),
                       "parent_seq": {int(live_seq[k]): int(live_seq[p]) if p >= 0 else -1 for k, p in
                                      enumerate(before_state.kf_parent.cpu().numpy())
                                      if before_state.kf_valid[k]}})

    gba_start = lc.GlobalBARunner.start

    def logged_gba_start(self, snapshot):
        events.append({"type": "gba_start", "frame": frame_now(), "snap": _centers(snapshot)})
        return gba_start(self, snapshot)

    insert = system.SlamSystem._insert_keyframe_async

    def logged_insert(self, res, ref_kf):
        snap_ref = res.state.kf_pose[ref_kf].cpu().numpy()
        live_state, _ = self._box.read()
        moved = bool(np.any(live_state.kf_pose[ref_kf].cpu().numpy() != snap_ref))
        assoc = int((res.frame.mp >= 0).sum())
        kept = int((DUMP.get("filter", system._live_associations)(res.frame.mp, res.state, live_state) >= 0).sum())
        insert(self, res, ref_kf)
        st, _ = self._box.read()
        k = self.ref_kf
        R, t = st.kf_pose[k, :3, :3].cpu().numpy(), st.kf_pose[k, :3, 3].cpu().numpy()
        events.append({"type": "kf", "frame": int(res.frame.frame_id), "tracker_frame": self.frame_id,
                       "seq": int(st.kf_seq[k]), "ref_seq": int(st.kf_seq[ref_kf]), "moved_ref": moved,
                       "assoc": assoc, "same_points": kept,
                       "center": (-R.T @ t).round(4).tolist()})

    enqueue, process, poses = system.SlamSystem._enqueue_pending, system.SlamSystem._process_pending, {}

    def logged_enqueue(self, res, timestamp):
        poses[self.frame_id] = sync.AsyncRead(res.pose)  # read at the decision, without a wait of its own
        return enqueue(self, res, timestamp)

    def logged_process(self, e):
        version = self._box.version
        ok = process(self, e)
        T = poses.pop(e.frame_id).numpy()
        events.append({"type": "frame", "frame": e.frame_id, "v_tracked": e.version, "v_decided": version,
                       "ref_kf": e.ref_kf, "center": (-T[:3, :3].T @ T[:3, 3]).round(4).tolist()})
        return ok

    from orb_slam2v2_1_tpu_torch.models import local_mapping

    lba = local_mapping.local_bundle_adjustment_impl

    def logged_lba(state, kf_id, K, bf):
        wb = local_mapping.build_local_ba_window(state, kf_id, K, bf)
        out, cost = lba(state, kf_id, K, bf)
        used = wb.cam_used.cpu().numpy()
        free = used & ~wb.win.cam_fixed.cpu().numpy()
        seq = state.kf_seq[wb.cam_kf].cpu().numpy()
        before, after = _centers(state), _centers(out)
        moves = {int(k): round(float(np.linalg.norm(np.array(after[k]) - np.array(before[k]))), 3)
                 for k in after if k in before and k in set(seq[used].tolist())}
        rec = {"type": "lba", "frame": frame_now(), "kf_seq": int(state.kf_seq[kf_id]),
               "free": seq[free].tolist(), "fixed": seq[used & ~free].tolist(),
               "obs": int(wb.win.valid.sum()), "inliers": int((out.kf_mp[wb.cam_kf] >= 0).sum()),
               "cost": float(cost), "moves": moves}
        events.append(rec)
        if LBA_DUMP["dir"] and moves and max(moves.values()) > LBA_DUMP["min_move"] and LBA_DUMP["n"] < LBA_DUMP["cap"]:
            from orb_slam2v2_1_tpu_torch.utils import serialization

            os.makedirs(LBA_DUMP["dir"], exist_ok=True)
            base = os.path.join(LBA_DUMP["dir"], f"lba_run{DUMP['run']}_{LBA_DUMP['n']}")
            serialization.save_map(state, base + "_map.npz", metadata={"kf_id": int(kf_id)})
            with open(base + ".json", "w") as f:
                json.dump(rec, f)
            LBA_DUMP["n"] += 1
        return out, cost

    local_mapping.local_bundle_adjustment_impl = logged_lba
    system.SlamSystem._start_async = logged_start_async
    lc.LoopCloser.apply_closure = logged_apply_closure
    lc.LoopCloser._merge = logged_merge
    lc.GlobalBARunner.start = logged_gba_start
    system.SlamSystem._insert_keyframe_async = logged_insert
    system.SlamSystem._enqueue_pending = logged_enqueue
    system.SlamSystem._process_pending = logged_process
    return events


def _install_fuse_gate(bf):
    """ORB-SLAM2's chi2 gate in the fusion's matches (5.991 on (u, v), 7.815
    with the right-image coordinate where the keypoint has one, at the
    keypoint's level), which neither package has: for a trial of the
    displaced tail's suspected cause on the card (ROADMAP queue 3)."""
    import torch

    from orb_slam2v2_1_tpu_torch.models import local_mapping
    from orb_slam2v2_1_tpu_torch.models.tracking import N_LEVELS, inv_level_sigma2
    from orb_slam2v2_1_tpu_torch.ops.projection import project

    fuse = local_mapping._fuse_candidates

    def gated(state, src_kf, dst_kf, pair_ok, K):
        ok, idx, dist, q_mp = fuse(state, src_kf, dst_kf, pair_ok, K)
        pose = state.kf_pose[dst_kf]
        pw = state.mp_pos[torch.clamp(q_mp, min=0).long()]
        uv = project(pose[:, None], pw, K)
        z = torch.einsum("bj,bnj->bn", pose[:, 2, :3], pw) + pose[:, 2, 3, None]
        i = idx.long()
        kp_xy = torch.gather(state.kf_xy[dst_kf], 1, i[..., None].expand(-1, -1, 2))
        kp_ur = torch.gather(state.kf_ur[dst_kf], 1, i)
        level = torch.clamp(torch.gather(state.kf_level[dst_kf], 1, i), 0, N_LEVELS - 1).long()
        stereo = kp_ur >= 0
        er = uv[..., 0] - bf / torch.clamp(z, min=1e-6) - kp_ur
        e2 = torch.sum((uv - kp_xy) ** 2, -1) + torch.where(stereo, er * er, torch.zeros_like(er))
        gate = torch.where(stereo, 7.815, 5.991)
        return ok & (e2 * inv_level_sigma2(z.device)[level] <= gate), idx, dist, q_mp

    local_mapping._fuse_candidates = gated


def _install_sim3_dump(out_dir):
    """Save the map, the pair and the card's hypothesis sets of each failed
    `compute_sim3` on a consistent candidate (see the module doc)."""
    import numpy as np

    from orb_slam2v2_1_tpu_torch import sync
    from orb_slam2v2_1_tpu_torch.models import loop_closing as lc
    from orb_slam2v2_1_tpu_torch.ops import prng, sim3solver
    from orb_slam2v2_1_tpu_torch.utils import serialization

    try_candidates = lc.LoopCloser._try_candidates

    def dumped(self, state, kf_id, cands, scores, consistent):
        out = try_candidates(self, state, kf_id, cands, scores, consistent)
        order = sorted(consistent, key=lambda gi: -scores[cands[gi]])[:3]
        for gi in order:
            cand = int(cands[gi])
            if out is not None and out[0] == cand or DUMP["n"] >= DUMP_CAP:
                break
            m = lc.match_keyframes(state, kf_id, cand, self.vocab)
            sets = sim3solver.hypothesis_sets(m.ok, prng.key(kf_id * 131 + cand))
            res = lc.compute_sim3(state, kf_id, cand, self.K, fix_scale=self.fix_scale, voc=self.vocab, sets=sets)
            os.makedirs(out_dir, exist_ok=True)
            base = os.path.join(out_dir, f"sim3_run{DUMP['run']}_{DUMP['n']}")
            DUMP["n"] += 1
            serialization.save_map(state, base + "_map.npz")
            np.savez(base + ".npz", kf=kf_id, cand=cand, sets=sets.cpu().numpy(), m_ok=m.ok.cpu().numpy(),
                     m_idx=m.idx.cpu().numpy(), success=bool(sync.host(res[0])), n_inl=int(sync.host(res[2])),
                     n_total=int(sync.host(res[3])), S12=res[1].cpu().numpy(),
                     accepted=-1 if out is None else int(out[0]))
        return out

    lc.LoopCloser._try_candidates = dumped


if __name__ == "__main__":
    main()
