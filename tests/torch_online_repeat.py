#!/usr/bin/env python3
"""bench.py's online leg (chip_smoke.py phase 11) several times on one card.

    python3 tests/torch_online_repeat.py [--runs 3] [--out DIR]

Needs one NVIDIA card; run from the repository root. The worker threads'
timing decides which frame becomes a keyframe and when a mapping round or
the loop closure lands, so runs of the async + pipelined leg differ: this
runs `chip_smoke.run_online_async` --runs times on the same rendered orbit,
prints each run's line (phase 11's, its ATE bound not applied) and the
spread of the run's estimated camera centers by segment of the orbit. The
orbit turns in place, so every true camera center coincides: a segment whose
mean center sits away from the first segment's was displaced. With --out,
each run's poses go to DIR/online_run<k>.npz and its map (`save_map`) to
DIR/online_map<k>.npz. Not a test: pytest does not
collect this file.
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

    kernels.build()
    card = kt.card_line()
    cfg = config.SlamConfig(**kt.BENCH)
    imgs, deps, gt = synthetic.orbit_frames(cfg, chip_smoke.LOOP_FRAMES, total=kt.ORBIT_TOTAL)
    chip_smoke.ONLINE_ASYNC_ATE_BOUND = float("inf")
    for run in range(runs):
        rec, _, slam = chip_smoke.run_online_async(imgs, deps, gt, cfg, card)
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
                          "segments": seg, "card": card}), flush=True)
        if out:
            os.makedirs(out, exist_ok=True)
            np.savez(os.path.join(out, f"online_run{run}.npz"), frames=frames,
                     Twc=np.stack([T for _, T in est]))
            slam.save_map(os.path.join(out, f"online_map{run}.npz"))


if __name__ == "__main__":
    main()
