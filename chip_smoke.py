#!/usr/bin/env python3
"""Smoke run of the PyTorch port (orb_slam2v2_1_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                # needs one CUDA card; run from the repo root
    python3 chip_smoke.py --profile DIR  # also writes a torch.profiler table of
                                         # frames 0-10 and the 96 poses to DIR

Phases, each of which raises (exit code != 0) on failure:
  1. require CUDA; print torch's version, the card, and nvidia-smi's name and
     power limit;
  2. build the hand-written CUDA kernels from csrc/ (timed as set-up);
  3. each kernel against its plain PyTorch version at the main path's shapes,
     on the card, exact, with CUDA-event timings (median of 20 calls after
     warm-up) of kernel and plain version;
  4. the main path: frames 0-95 of the benchmark's 321-frame RGB-D orbit,
     rendered on the card, through `models.offline.track_sequence_rgbd` at the
     benchmark configuration (640x480, 1000 features, 8 levels, 128 keyframes,
     16384 map points); launch counts of both kernels, tracked share, ATE
     against the orbit's ground truth, frames/s; the first frames are also run
     on the CPU (plain versions) and must agree.
The second-to-last line is a JSON object of per-kernel results; the last line
is {"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

BENCH = dict(fx=550.0, fy=550.0, cx=320.0, cy=240.0, width=640, height=480, n_features=1000,
             max_keyframes=128, max_map_points=16384, fps=10.0, bf=44.0, th_depth=100.0)
N_FRAMES, ORBIT_TOTAL = 96, 321
# ATE bound (metres): twice the JAX reference's ATE on the same 96 frames,
# 0.1431 m measured with the JAX package on the CPU (rigid-aligned). Without
# loop closing the reference itself misses the 0.02 m bound on this orbit.
ATE_BOUND = 2 * 0.1431
CPU_CHECK_FRAMES = 6


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n=20, warmup=3):
    """Median device time of one call of fn, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def ate_rigid(est_centers, gt_centers):
    """RMS position error after a rigid (rotation + translation) Horn
    alignment, as the repository's trajectory.ate_rmse without scale."""
    import numpy as np

    P, Q = est_centers.T.astype(np.float64), gt_centers.T.astype(np.float64)
    mu_p, mu_q = P.mean(1, keepdims=True), Q.mean(1, keepdims=True)
    U, _, Vt = np.linalg.svd((Q - mu_q) @ (P - mu_p).T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    err = R @ P + (mu_q - R @ mu_p) - Q
    return float(np.sqrt((err * err).sum(0).mean()))


def centers(poses):
    import numpy as np

    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])


def check_fast(img, cfg):
    import torch
    from orb_slam2v2_1_tpu_torch import kernels
    from orb_slam2v2_1_tpu_torch.ops import fast, image

    levels = [lvl.contiguous() for lvl in image.build_pyramid(img, cfg.n_levels, cfg.scale_factor)]
    err, ms, plain_ms, shapes = 0.0, 0.0, 0.0, []
    for lvl in levels:
        got = kernels.fast_score_nms(lvl)
        ref = fast.nms3(fast.fast_score(lvl))
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"fast_score_nms differs from nms3(fast_score) at {tuple(lvl.shape)}")
        err = max(err, float((got - ref).abs().max()))
        k_ms = cuda_ms(lambda: kernels.fast_score_nms(lvl))
        p_ms = cuda_ms(lambda: fast.nms3(fast.fast_score(lvl)))
        ms += k_ms
        plain_ms += p_ms
        shapes.append({"shape": list(lvl.shape), "ms": k_ms, "plain_ms": p_ms})
        log(f"fast_score_nms {tuple(lvl.shape)}: equal, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shapes": shapes}


def check_match(dev, rng):
    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch import kernels
    from orb_slam2v2_1_tpu_torch.ops import hamming, matching

    def feats(b, n):
        words = hamming.words_from_uint32(rng.integers(0, 2**32, (b, n, 8), dtype=np.uint32))
        words[:, 5::7] = words[:, :1]  # ties of the best distance
        xy = np.stack([rng.uniform(0, 640, (b, n)), rng.uniform(0, 480, (b, n))], -1)
        lvl = rng.integers(0, 8, (b, n))
        valid = rng.uniform(size=(b, n)) > 0.1
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                (words, xy.astype(np.float32), lvl.astype(np.int32), valid)]

    err, out = 0.0, {}
    # Motion model (1000 x 1000), local map (4096 x 1000), batched fuse (20 x 1000 x 1000).
    for name, (b, q, n) in (("motion", (1, 1000, 1000)), ("local_map", (1, 4096, 1000)),
                            ("fuse", (20, 1000, 1000))):
        qf, tf = feats(b, q), feats(b, n)
        r = torch.from_numpy(rng.uniform(5, 60, (b, q)).astype(np.float32)).to(dev)
        idx, best, second = matching.masked_best_two(*qf, r, *tf)
        ridx, rbest, rsecond = matching.masked_best_two_plain(*qf, r, *tf)
        torch.cuda.synchronize()
        has = rbest < matching.BIG
        if not (torch.equal(best, rbest) and torch.equal(second, rsecond) and torch.equal(idx[has], ridx[has])):
            raise AssertionError(f"masked_best_two differs from the plain version at {(b, q, n)}")
        for g, e in ((best, rbest), (second, rsecond), (idx[has], ridx[has])):
            err = max(err, float((g.long() - e.long()).abs().max()) if g.numel() else 0.0)
        k_ms = cuda_ms(lambda: matching.masked_best_two(*qf, r, *tf))
        p_ms = cuda_ms(lambda: matching.masked_best_two_plain(*qf, r, *tf))
        out[name] = {"shape": [b, q, n], "ms": k_ms, "plain_ms": p_ms, "with_candidate": float(has.float().mean())}
        log(f"masked_best_two {(b, q, n)}: equal ({float(has.float().mean()):.2f} of rows with a candidate),"
            f" kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return {"max_abs_err": err, "ms": out["local_map"]["ms"], "plain_ms": out["local_map"]["plain_ms"],
            "shapes": list(out.values())}


def main():
    import numpy as np
    import torch

    args = sys.argv[1:]
    if args and not (len(args) == 2 and args[0] == "--profile"):
        raise SystemExit(__doc__)
    out_dir = os.path.abspath(args[1]) if args else None
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this smoke run needs an NVIDIA card")
    sys.path.insert(0, ROOT)
    import orb_slam2v2_1_tpu_torch as port

    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) != ROOT:
        raise SystemExit(f"chip_smoke: expected the port beside this script, found {port.__file__}")
    from orb_slam2v2_1_tpu_torch import kernels, sync
    from orb_slam2v2_1_tpu_torch.models import offline
    from orb_slam2v2_1_tpu_torch.utils import config, synthetic

    cfg = config.SlamConfig(**BENCH)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "not measured"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(card)

    t0 = time.perf_counter()
    build_s = kernels.build(verbose=True)
    log(f"kernel build: {build_s:.1f} s (nvcc), set-up total {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    imgs, deps, gt = synthetic.orbit_frames(cfg, N_FRAMES, device=dev, total=ORBIT_TOTAL)
    torch.cuda.synchronize()
    log(f"rendered {N_FRAMES} orbit frames on the card in {time.perf_counter() - t0:.1f} s")
    if not (torch.isfinite(imgs).all() and (deps > 0).float().mean() > 0.99):
        raise AssertionError("rendered frames are not finite or lack depth")

    rng = np.random.default_rng(0)
    fast_res = check_fast(imgs[0].contiguous(), cfg)
    match_res = check_match(dev, rng)

    # --- the main path ---
    kernels.reset_launch_counts()
    sync.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, ok, state = offline.track_sequence_rgbd(imgs, deps, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    syncs = sync.COUNT["syncs"]

    if poses.shape != (N_FRAMES, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"poses: shape {poses.shape}, finite {np.isfinite(poses).all()}")
    gt_rel = np.stack([g @ np.linalg.inv(gt[0]) for g in gt])  # ground truth, world = first camera
    c_est, c_gt = centers(poses), centers(gt_rel)
    ate = ate_rigid(c_est[ok], c_gt[ok])
    ate_anchored = float(np.sqrt(np.mean(np.sum((c_est[ok] - c_gt[ok]) ** 2, axis=1))))
    n_ok = int(ok.sum())
    n_kf = int(state.kf_valid.sum())
    n_mp = int(state.mp_valid.sum())
    log(f"main path: {n_ok}/{N_FRAMES} tracked, {n_kf} keyframes, {n_mp} live map points, "
        f"ATE {ate:.4f} m (rigid-aligned), {ate_anchored:.4f} m (first-frame anchored), "
        f"wall {wall:.2f} s = {N_FRAMES / wall:.2f} frames/s incl. initialization, "
        f"launches {launches}, host syncs {syncs} ({syncs / N_FRAMES:.1f}/frame)")
    if n_ok < 0.9 * N_FRAMES:
        raise AssertionError(f"tracked {n_ok}/{N_FRAMES} < 90%")
    if not ate <= ATE_BOUND:
        raise AssertionError(f"ATE {ate:.4f} m > {ATE_BOUND} m")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")

    # --- the same frames through the plain versions on the CPU ---
    cpu_poses, cpu_ok, _ = offline.track_sequence_rgbd(
        imgs[:CPU_CHECK_FRAMES].cpu(), deps[:CPU_CHECK_FRAMES].cpu(), cfg)
    dc = np.linalg.norm(centers(cpu_poses) - c_est[:CPU_CHECK_FRAMES], axis=1).max()
    log(f"CPU plain path, frames 0-{CPU_CHECK_FRAMES - 1}: ok {cpu_ok.tolist()}, max center diff {dc:.2e} m")
    if not (np.array_equal(cpu_ok, ok[:CPU_CHECK_FRAMES]) and dc <= 2e-3):
        raise AssertionError("the card's path disagrees with the CPU plain path")

    if out_dir:
        profile(offline, imgs, deps, cfg, out_dir)
        np.savez(os.path.join(out_dir, "chip_smoke_poses.npz"), poses=poses, ok=ok)

    def entry(name, res, src, line):
        return {"name": name, "route": "cuda", "source": f"orb_slam2v2_1_tpu_torch/csrc/{src}",
                "replaces": f"orb_slam2v2_1_tpu/ops/pallas_kernels.py:{line}", "launches": launches[name],
                "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
                "shapes": res["shapes"]}

    print(json.dumps({
        "kernels": [entry("fast_score_nms", fast_res, "fast_score_nms.cu", 137),
                    entry("masked_best_two", match_res, "masked_best_two.cu", 225)],
        "main_path": {"frames": N_FRAMES, "tracked": n_ok, "keyframes": n_kf, "map_points": n_mp,
                      "ate_m": ate, "ate_anchored_m": ate_anchored, "wall_s": wall,
                      "fps": N_FRAMES / wall, "host_syncs": syncs, "card": card},
    }), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def profile(offline, imgs, deps, cfg, out_dir, n=11):
    """Frames 0-10 of the main path, once timed and once under torch.profiler:
    the device's busy share (kernel time in the profile over the unprofiled
    wall time), and tables by device and by host time in
    out_dir/profile_main_path.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    offline.track_sequence_rgbd(imgs[:n], deps[:n], cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        offline.track_sequence_rgbd(imgs[:n], deps[:n], cfg)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in avg if e.device_type == DeviceType.CUDA) / 1e3
    n_kernels = sum(e.count for e in avg if e.device_type == DeviceType.CUDA)
    log(f"profile, frames 0-{n - 1}: wall {wall * 1e3:.1f} ms unprofiled, device kernel time {dev_ms:.1f} ms "
        f"in {n_kernels} kernels, device busy share {dev_ms / (wall * 1e3):.3f}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_main_path.txt"), "w") as f:
        f.write(avg.table(sort_by="self_device_time_total", row_limit=40))
        f.write(avg.table(sort_by="cpu_time_total", row_limit=60))


if __name__ == "__main__":
    main()
