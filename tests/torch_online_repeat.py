#!/usr/bin/env python3
"""bench.py's online leg (chip_smoke.py phase 11) several times on one card.

    python3 tests/torch_online_repeat.py [--runs 3] [--out DIR] [--loop-log]

Needs one NVIDIA card; run from the repository root. The worker threads'
timing decides which frame becomes a keyframe and when a mapping round or
the loop closure lands, so runs of the async + pipelined leg differ: this
runs `chip_smoke.run_online_async` --runs times on the same rendered orbit,
prints each run's line (phase 11's, none of its assertions applied, so a
run that would fail the phase is recorded and the next one starts), with
its loops, relocalizations and the decision vector of each lost frame, and
the spread of the run's estimated camera centers by segment of the orbit. The
orbit turns in place, so every true camera center coincides: a segment whose
mean center sits away from the first segment's was displaced. With --out,
each run's poses go to DIR/online_run<k>.npz and its map (`save_map`) to
DIR/online_map<k>.npz. With --loop-log each run also prints every loop
detection round: its insertion count and keyframe, the live keyframes, the
candidates, how many reached the 3-round consistency, and each Sim3 tried
(candidate, accepted, inliers). Not a test: pytest does not collect this
file.
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

        detect, consistent, sim3 = lc.LoopCloser.detect_loop, lc.LoopCloser._consistent, lc.compute_sim3

        def logged_detect(self, state, kf_id, n_kf):
            rounds.append({"count": self.kf_counter + 1, "kf": int(kf_id), "n_kf": n_kf, "cands": None,
                           "consistent": None, "sim3": []})
            return detect(self, state, kf_id, n_kf)

        def logged_consistent(self, cands, C):
            out = consistent(self, cands, C)
            rounds[-1].update(cands=[int(c) for c in cands], consistent=[int(cands[g]) for g in out])
            return out

        def logged_sim3(state, kf_cur, kf_cand, *a, **k):
            out = sim3(state, kf_cur, kf_cand, *a, **k)
            if rounds:
                rounds[-1]["sim3"].append((int(kf_cand), bool(sync.host(out[0])), int(sync.host(out[2]))))
            return out

        lc.LoopCloser.detect_loop, lc.LoopCloser._consistent, lc.compute_sim3 = (logged_detect, logged_consistent,
                                                                                  logged_sim3)
    kernels.build()
    card = kt.card_line()
    cfg = config.SlamConfig(**kt.BENCH)
    imgs, deps, gt = synthetic.orbit_frames(cfg, chip_smoke.LOOP_FRAMES, total=kt.ORBIT_TOTAL)
    chip_smoke.ONLINE_ASYNC_ATE_BOUND = float("inf")
    for run in range(runs):
        rounds.clear()
        rec, _, slam = chip_smoke.run_online_async(imgs, deps, gt, cfg, card, check=False)
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
                          "keyframes": rec["keyframes"], "closures": slam.loop_closer.closures,
                          "loops_closed": slam.n_loops_closed, "relocalizations_at": rec["relocalizations_at"],
                          "losses": slam.losses,
                          "segments": seg, "card": card}), flush=True)
        if out:
            os.makedirs(out, exist_ok=True)
            np.savez(os.path.join(out, f"online_run{run}.npz"), frames=frames,
                     Twc=np.stack([T for _, T in est]))
            slam.save_map(os.path.join(out, f"online_map{run}.npz"))


if __name__ == "__main__":
    main()
