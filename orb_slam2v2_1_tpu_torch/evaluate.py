"""Accuracy evaluation harness: ATE RMSE per sequence, gated.

Port of the repository's `evaluate.py`, function by function, with its
arguments, legs, seeds, configurations, gates and `EVAL.json` layout:

  python -m orb_slam2v2_1_tpu_torch.evaluate [--frames 150] [--out EVAL.json] [--quick] [--cpu]
  python -m orb_slam2v2_1_tpu_torch.evaluate --tum DIR [--settings YAML] [--cpu]

The run is on the NVIDIA card and raises when there is none; `--cpu` runs it
on the CPU. Without a dataset it evaluates six synthetic legs, clean scenes
and their adversarial twins (non-planar clutter with occlusion, low texture,
exposure steps, motion blur and sensor noise; `utils/synthetic.py`), gated:

  clean sequences:  ATE <= the BASELINE.md paper anchor x1.05 (TUM fr1/desk
                    RGB-D 0.016 m, fr1/xyz mono 0.009 m scale-aligned, EuRoC
                    MH_01 stereo 0.035 m);
  adversarial:      >= 85% frames tracked after the first pose AND ATE <=
                    max(3x clean twin, 0.05 m).

`--quick` drops the two stereo legs. `--tum DIR` evaluates a TUM RGB-D
sequence directory instead (`utils/datasets.load_tum_rgbd`), with the
settings file's camera or TUM fr1's, gated at 0.016 m x1.05. `EVAL.json`
holds the per-sequence metrics and the gates; the exit code is 1 when a gate
fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from . import device as device_mod
from . import sync
from .models.system import Sensor, SlamSystem
from .utils import datasets, synthetic
from .utils.config import TUM_FR1, SlamConfig, load_settings
from .utils.trajectory import ate_rmse


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_sequence(cfg, sensor, frames, timestamps, gt, align_scale=False, async_mapping=False, device=None,
                 slam=None):
    """Track a prepared sequence through the product API; return metrics.
    `frames` are (image, depth), (left, right) or (image, None) pairs; `gt`
    maps timestamps to ground-truth Twc. `slam`: a `SlamSystem` of `cfg` and
    `sensor` to drive instead of a new one, for a caller that reads its
    counters afterwards; it is shut down here as a new one would be."""
    if slam is None:
        slam = SlamSystem(config=cfg, sensor=sensor, async_mapping=async_mapping, device=device)
    try:
        t0 = time.time()
        for ts, fr in zip(timestamps, frames):
            if sensor == Sensor.RGBD:
                slam.track_rgbd(fr[0], fr[1], ts)
            elif sensor == Sensor.STEREO:
                slam.track_stereo(fr[0], fr[1], ts)
            else:
                slam.track_monocular(fr[0], ts)
        wall = time.time() - t0
    finally:
        slam.shutdown()
    entries = slam.trajectory.entries
    ok = sum(1 for e in entries if not e.lost)
    # Post-initialization coverage: mono spends its first frames
    # bootstrapping by design; the robustness gate is about not LOSING the
    # track once it exists.
    n_post = 0
    for k, e in enumerate(entries):
        if not e.lost:
            n_post = len(entries) - k
            break
    (kf_pose,) = sync.host_numpy(slam.map.kf_pose)  # the final map: the workers have stopped
    ate = ate_rmse(slam.trajectory.absolute_poses(kf_pose), gt, align_scale=align_scale)
    return {
        "ate_rmse_m": round(float(ate), 5),
        "tracked": ok,
        "frames": len(frames),
        "tracked_frac": round(ok / max(len(frames), 1), 3),
        "tracked_frac_post_init": round(ok / max(n_post, 1), 3),
        "n_kf": slam.n_kf_host,
        "n_loops": slam.n_loops_closed,
        "n_resets": slam.n_resets,
        "wall_s": round(wall, 1),
    }


def _timestamps(n):
    return [i * 0.1 for i in range(n)]


def _gt_of(poses):
    return {i * 0.1: np.linalg.inv(poses[i]) for i in range(len(poses))}


def _norm(poses):
    return [p @ np.linalg.inv(poses[0]) for p in poses]


def evaluate_synthetic(n_frames: int, quick: bool = False, device=None):
    """The six synthetic legs (four with `quick`) and their gates: returns
    (results by leg, checks by gate)."""
    dev = device_mod.resolve(device)
    cfg = SlamConfig(
        fx=550.0, fy=550.0, cx=320.0, cy=240.0, width=640, height=480,
        n_features=1000, max_keyframes=128, max_map_points=16384, fps=10.0,
        bf=44.0, th_depth=40.0,
    )
    cfg_mono = dataclasses.replace(cfg, bf=0.0)
    results = {}

    # -- RGB-D: clean desk + adversarial clutter twins --------------------
    desk = synthetic.make_desk(np.random.default_rng(7), device=dev)
    log(f"[clean_desk_rgbd] rendering {n_frames} frames...")
    imgs, deps, poses = synthetic.desk_frames(cfg, synthetic.desk_trajectory(n_frames), scene=desk)
    results["clean_desk_rgbd"] = run_sequence(
        cfg, Sensor.RGBD, list(zip(imgs, deps)), _timestamps(len(poses)), _gt_of(poses), device=dev,
    )
    log(f"[clean_desk_rgbd] {results['clean_desk_rgbd']}")

    rng = np.random.default_rng(21)
    adv = synthetic.make_adversarial(rng, device=dev)
    poses_a = _norm(synthetic.desk_trajectory(n_frames, extent=0.55))
    log("[adv_clutter_rgbd] rendering (occlusion+low-texture+exposure+blur+noise)...")
    imgs, deps = synthetic.adversarial_frames(cfg, adv, poses_a, rng, "rgbd")
    results["adv_clutter_rgbd"] = run_sequence(
        cfg, Sensor.RGBD, list(zip(imgs, deps)), _timestamps(len(poses_a)), _gt_of(poses_a), device=dev,
    )
    log(f"[adv_clutter_rgbd] {results['adv_clutter_rgbd']}")

    # -- Monocular: clean + adversarial -----------------------------------
    # The clean leg degrades nothing (evaluate.py's generator of seed 9 goes
    # unused): the desk of seed 7 seen along the lateral sweep. Its two-view
    # RANSAC draws the reference's sets, from the reference's key.
    n_mono = max(n_frames * 2 // 3, 40)
    log("[clean_mono] rendering...")
    imgs, _, poses_m = synthetic.desk_frames(cfg_mono, synthetic.lateral_trajectory(n_mono), scene=desk)
    results["clean_mono"] = run_sequence(
        cfg_mono, Sensor.MONOCULAR, [(img, None) for img in imgs], _timestamps(len(poses_m)), _gt_of(poses_m),
        align_scale=True, device=dev,
    )
    log(f"[clean_mono] {results['clean_mono']}")

    # Mono adversarial twin: clutter tilt bounded at 35 deg (unconstrained
    # slant defeats any two-view bootstrap) + a gentler sweep, blur-free
    # with gentler exposure steps; keeps occlusion, low texture, exposure
    # steps and noise.
    rng = np.random.default_rng(33)
    adv_m = synthetic.make_adversarial(np.random.default_rng(22), max_tilt_deg=35.0, device=dev)
    poses_ma = _norm(synthetic.lateral_trajectory(len(poses_m), extent=0.9))
    log("[adv_mono] rendering...")
    imgs, _ = synthetic.adversarial_frames(cfg_mono, adv_m, poses_ma, rng, "mono")
    results["adv_mono"] = run_sequence(
        cfg_mono, Sensor.MONOCULAR, [(img, None) for img in imgs], _timestamps(len(poses_ma)), _gt_of(poses_ma),
        align_scale=True, device=dev,
    )
    log(f"[adv_mono] {results['adv_mono']}")

    if not quick:
        # -- Stereo forward dolly (KITTI character) -----------------------
        # th_depth=100 (-> 8 m close-point limit): the room is 8 m deep and
        # forward motion needs far stereo anchors, the per-dataset
        # working-range tuning the reference's settings files do.
        cfg_st = dataclasses.replace(cfg, th_depth=100.0)
        n_st = n_frames // 2
        log("[stereo_dolly] rendering...")
        left, right, poses_s = synthetic.stereo_dolly_frames(cfg_st, range(n_st), np.random.default_rng(3),
                                                             device=dev)
        results["stereo_dolly"] = run_sequence(
            cfg_st, Sensor.STEREO, list(zip(left, right)), _timestamps(n_st), _gt_of(poses_s), device=dev,
        )
        log(f"[stereo_dolly] {results['stereo_dolly']}")

        # -- Adversarial stereo: the same room and dolly, degraded ---------
        room = synthetic.make_room(np.random.default_rng(3), device=dev)
        log("[adv_stereo_dolly] rendering...")
        left, right = synthetic.adversarial_frames(cfg_st, room, list(poses_s), np.random.default_rng(43), "stereo")
        results["adv_stereo_dolly"] = run_sequence(
            cfg_st, Sensor.STEREO, list(zip(left, right)), _timestamps(n_st), _gt_of(poses_s), device=dev,
        )
        log(f"[adv_stereo_dolly] {results['adv_stereo_dolly']}")

    # -- Gates -------------------------------------------------------------
    # Clean anchors: BASELINE.md paper numbers x1.05 (TUM fr1/desk RGB-D
    # 0.016 m; fr1/xyz mono 0.009 m scale-aligned; EuRoC MH_01 stereo
    # 0.035 m).
    gates = {
        "clean_desk_rgbd": ("ate_rmse_m", 0.016 * 1.05),
        "clean_mono": ("ate_rmse_m", 0.009 * 1.05),
    }
    if "stereo_dolly" in results:
        gates["stereo_dolly"] = ("ate_rmse_m", 0.035 * 1.05)
    checks = {}
    for name, (key, bound) in gates.items():
        checks[name] = {
            "bound": round(bound, 5),
            "value": results[name][key],
            "pass": bool(results[name][key] <= bound),
        }
    for adv_name, clean_name in (
        ("adv_clutter_rgbd", "clean_desk_rgbd"),
        ("adv_mono", "clean_mono"),
        ("adv_stereo_dolly", "stereo_dolly"),
    ):
        if adv_name not in results or clean_name not in results:
            continue
        bound = max(3.0 * results[clean_name]["ate_rmse_m"], 0.05)
        checks[adv_name] = {
            "bound": round(bound, 5),
            "value": results[adv_name]["ate_rmse_m"],
            "tracked_frac_post_init": results[adv_name]["tracked_frac_post_init"],
            "pass": bool(
                results[adv_name]["ate_rmse_m"] <= bound
                and results[adv_name]["tracked_frac_post_init"] >= 0.85
            ),
        }
    return results, checks


def evaluate_tum(root, settings=None, device=None):
    """A TUM RGB-D sequence directory through the RGB-D path, gated at the
    reference's TUM fr1/desk anchor."""
    dev = device_mod.resolve(device)
    cfg = load_settings(settings) if settings else TUM_FR1
    pairs, gt = datasets.load_tum_rgbd(root)
    frames, ts = [], []
    for fr in pairs:
        img = datasets.read_image_gray(fr["rgb"])
        depth = datasets.read_depth_tum(fr["depth"], cfg.depth_map_factor)
        frames.append((torch.from_numpy(img).to(dev), torch.from_numpy(depth).to(dev)))
        ts.append(fr["t"])
    res = run_sequence(cfg, Sensor.RGBD, frames, ts, gt, device=dev)
    # Reference anchor: ORB-SLAM2 TRO'17 TUM fr1/desk 0.016 m (BASELINE.md).
    checks = {
        "tum_rgbd": {
            "bound": 0.016 * 1.05, "value": res["ate_rmse_m"],
            "pass": bool(res["ate_rmse_m"] <= 0.016 * 1.05),
        }
    }
    return {"tum_rgbd": res}, checks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=150)
    p.add_argument("--out", default="EVAL.json")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--tum", default=None, help="TUM RGB-D sequence directory")
    p.add_argument("--settings", default=None)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the NVIDIA card)")
    args = p.parse_args(argv)
    device = device_mod.resolve("cpu" if args.cpu else None)  # no card and no --cpu: fail before any work

    if args.tum:
        results, checks = evaluate_tum(args.tum, args.settings, device=device)
        source = "tum"
    else:
        results, checks = evaluate_synthetic(args.frames, quick=args.quick, device=device)
        source = "synthetic_adversarial"

    out = {
        "source": source,
        "note": (
            "Real TUM/KITTI/EuRoC files are not present in this environment "
            "(zero egress); synthetic clean+adversarial twins proxy the "
            "BASELINE.md <=1.05x gate as declared in evaluate.py's header. "
            "Pass --tum/--kitti at a dataset directory to evaluate the real "
            "benchmark through the same code path."
            if source != "tum" else "Real-dataset evaluation."
        ),
        "sequences": results,
        "gates": checks,
        "all_pass": bool(all(c["pass"] for c in checks.values())),
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return 0 if out["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
