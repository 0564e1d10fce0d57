"""Command-line SLAM runner: the ros_mono / ros_rgbd node analog.

Port of the JAX package's `run_slam.py`, with its flags and output lines:

  python -m orb_slam2v2_1_tpu_torch.run_slam --dataset synthetic [--sensor rgbd]
  python -m orb_slam2v2_1_tpu_torch.run_slam --dataset /path/to/tum_dir --sensor rgbd \\
      --settings config.yaml --out traj.txt [--save-map m.npz] [--ply m.ply] [--viz-dir DIR]

It prints the tracking state per frame, writes the TUM-format trajectory and,
where there is ground truth, the ATE RMSE. The run is on the NVIDIA card and
raises when there is none; `--cpu` runs it on the CPU. Mapping runs on the
worker threads unless `--sync` is given, as in the reference. `--viz-dir`
records frame and map PNGs for a dataset run as well as for the synthetic
one (the reference records only the synthetic run).
"""

from __future__ import annotations

import argparse
import sys
import time


def _fmt_stats(st: dict) -> str:
    """One line of `SlamSystem.stats()`: rolling per-stage latency and the
    map counters (the FrameDrawer status bar, src/FrameDrawer.cc:132-168)."""

    def ms(v):
        return "-" if v is None else f"{v:.1f}"

    return (f"{st['state']} track p50/p90={ms(st['track_ms_p50'])}/"
            f"{ms(st['track_ms_p90'])}ms map p50={ms(st['map_ms_p50'])}ms "
            f"loop p50={ms(st['loop_ms_p50'])}ms gba={ms(st['gba_ms_last'])}ms "
            f"kf={st['n_kf']} loops={st['n_loops']} resets={st['n_resets']} "
            f"inflight={st['in_flight']} ba_skip={st['ba_skipped']}")


def main(argv=None):
    p = argparse.ArgumentParser(description="ORB-SLAM on PyTorch")
    p.add_argument("--dataset", default="synthetic", help="'synthetic' or a TUM RGB-D directory")
    p.add_argument("--sensor", default="rgbd", choices=["mono", "rgbd", "stereo"])
    p.add_argument("--settings", default=None, help="settings file (reference YAML style)")
    p.add_argument("--out", default="trajectory_tum.txt")
    p.add_argument("--save-map", default=None)
    p.add_argument("--ply", default=None, help="export sparse map PLY")
    p.add_argument("--viz-dir", default=None, help="record frame/map PNGs (the Pangolin viewer analog)")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the NVIDIA card)")
    p.add_argument("--stats-every", type=int, default=30,
                   help="print SlamSystem.stats() every N frames (per-stage latency + map counters)")
    p.add_argument("--sync", action="store_true",
                   help="synchronous mapping (default: LocalMapping/LoopClosing worker threads, "
                        "the reference's architecture)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from . import sync
    from .models.system import Sensor, SlamSystem
    from .utils.config import TUM_FR1, SlamConfig, load_settings
    from .utils.trajectory import ate_rmse

    device = "cpu" if args.cpu else None
    sensor = {"mono": Sensor.MONOCULAR, "rgbd": Sensor.RGBD, "stereo": Sensor.STEREO}[args.sensor]
    rec = None
    if args.viz_dir:
        from .utils.viz import FrameRecorder

        rec = FrameRecorder(args.viz_dir)

    if args.dataset == "synthetic":
        from .utils import synthetic

        cfg = SlamConfig(
            fx=550.0, fy=550.0, cx=320.0, cy=240.0, width=640, height=480,
            n_features=1000, max_keyframes=128, max_map_points=16384, fps=10.0,
            bf=44.0 if sensor != Sensor.MONOCULAR else 0.0, th_depth=40.0,
        )
        slam = SlamSystem(config=cfg, sensor=sensor, async_mapping=not args.sync, device=device)
        imgs, deps, poses = synthetic.desk_frames(cfg, synthetic.desk_trajectory(args.frames), device=slam.device)
        gt = {i * 0.1: np.linalg.inv(poses[i]) for i in range(len(poses))}
        t0 = time.time()
        for i in range(len(poses)):
            if sensor == Sensor.RGBD:
                slam.track_rgbd(imgs[i], deps[i], i * 0.1)
            else:
                slam.track_monocular(imgs[i], i * 0.1)
            if rec is not None and slam.last_frame is not None:
                rec.record(imgs[i], slam.last_frame, slam.map, slam.state.name)
            n_mp = sync.host(torch.sum(slam.map.mp_valid))
            print(f"frame {i:04d}: {slam.state.name:16s} kf={slam.n_kf_host:3d} "
                  f"mp={n_mp:5d} loops={slam.n_loops_closed}")
            if i and i % args.stats_every == 0:
                print("  stats:", _fmt_stats(slam.stats()))
        wall = time.time() - t0
    else:
        from .utils import datasets

        cfg = load_settings(args.settings) if args.settings else TUM_FR1
        pairs, gt = datasets.load_tum_rgbd(args.dataset)
        slam = SlamSystem(config=cfg, sensor=sensor, async_mapping=not args.sync, device=device)
        t0 = time.time()
        for i, fr in enumerate(pairs):
            img = datasets.read_image_gray(fr["rgb"])
            depth = datasets.read_depth_tum(fr["depth"], cfg.depth_map_factor)
            if sensor == Sensor.RGBD:
                slam.track_rgbd(img, depth, fr["t"])
            else:
                slam.track_monocular(img, fr["t"])
            if rec is not None and slam.last_frame is not None:
                rec.record(img, slam.last_frame, slam.map, slam.state.name)
            if i % 10 == 0:
                print(f"frame {i:04d}/{len(pairs)}: {slam.state.name:16s} "
                      f"kf={slam.n_kf_host:3d} loops={slam.n_loops_closed}")
            if i and i % args.stats_every == 0:
                print("  stats:", _fmt_stats(slam.stats()))
        wall = time.time() - t0

    slam.shutdown()  # drain the mapping/loop workers (nothing to do with --sync)
    print("final stats:", _fmt_stats(slam.stats()))
    slam.save_trajectory_tum(args.out)
    n = len(slam.trajectory.entries)
    print(f"\n{n} frames in {wall:.1f}s ({n/wall:.1f} fps) -> {args.out}")
    if args.save_map:
        slam.save_map(args.save_map)
        print(f"map saved -> {args.save_map}")
    if args.ply:
        from .utils.pointcloud import export_sparse_map_ply

        export_sparse_map_ply(slam.map, args.ply)
        print(f"sparse cloud -> {args.ply}")
    if gt:
        (kf_poses,) = sync.host_numpy(slam.map.kf_pose)
        err = ate_rmse(slam.trajectory.absolute_poses(kf_poses), gt, align_scale=sensor == Sensor.MONOCULAR)
        print(f"ATE RMSE: {err:.4f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
