#!/usr/bin/env python3
"""Device times of the hand-written kernels at the main path's shapes.

    python3 orb_slam2v2_1_tpu_torch/kernel_times.py [--root DIR] [--out FILE]

needs one NVIDIA card. `--root DIR` times the package of another checkout
(for example the parent commit unpacked with `git archive`), so that two
versions are measured in one call on one card; forms that the other checkout
lacks are left out. `--out FILE` also writes the result as JSON.

Three clocks per case, all on the card:
  - `graph_us`: many calls captured in one CUDA graph and replayed between
    two events, over the number of calls. No Python and no launch call is
    inside; the gaps between dependent kernels are. Every call in the graph
    has its own outputs; all calls read the same inputs, which therefore stay
    in the L2 cache, as they do on the main path, where each input was
    written just before.
  - `busy_us` and `kernels`: the profiler's kernel rows of the same calls,
    run eagerly: the sum of the kernels' own durations, and how many kernels
    one call launches.
  - `wrapper_us`: events around one eager call (median of 20), wrapper and
    launch included, as the port pays it.
The empty kernel of `csrc/launch_floor.cu` goes through the same clocks: it
is the floor under any bound of a few microseconds.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

BENCH = dict(fx=550.0, fy=550.0, cx=320.0, cy=240.0, width=640, height=480, n_features=1000,
             max_keyframes=128, max_map_points=16384, fps=10.0, bf=44.0, th_depth=100.0)
ORBIT_TOTAL = 321
# evaluate.py's configuration of the desk sequences (clean_desk_rgbd; bf=0 for
# clean_mono): the benchmark's, with th_depth=40.
EVAL = dict(BENCH, th_depth=40.0)
# The widest configuration the repository runs: bench.py's KITTI-geometry
# stereo leg (1241x376, 2000 features).
KITTI = dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22, width=1241, height=376, n_features=2000,
             max_keyframes=64, max_map_points=16384, fps=10.0, bf=386.14, th_depth=35.0)
# (name, (batch, queries, targets), (frame width, frame height), (max_dist,
# nn_ratio), radius) of the callers of match_projection: motion model, local
# map, and the batched fuse of a keyframe insertion; then loop closing's
# searches: one Sim3 candidate's projection search, and the loop fusion at
# its smallest buckets (16 keyframes x 4096 loop-side points); then the KITTI
# geometry's (2000 keypoints a frame) motion model, local map and fuse; then
# the monocular motion model, whose window is 15 px x the query's level scale
# (7 px for the depth sensors). A radius of None draws each query's radius
# uniformly from 5-60 px.
VGA = (640, 480)
KITTI_FRAME = (KITTI["width"], KITTI["height"])
SEARCH_SHAPES = (("motion", (1, 1000, 1000), VGA, (100, 0.9), None),
                 ("local_map", (1, 4096, 1000), VGA, (100, 0.8), None),
                 ("fuse", (20, 1000, 1000), VGA, (50, 1.0), None), ("sim3", (1, 1000, 1000), VGA, (100, 1.0), None),
                 ("loop_fuse", (16, 4096, 1000), VGA, (50, 1.0), None),
                 ("kitti_motion", (1, 2000, 2000), KITTI_FRAME, (100, 0.9), None),
                 ("kitti_local_map", (1, 4096, 2000), KITTI_FRAME, (100, 0.8), None),
                 ("kitti_fuse", (20, 2000, 2000), KITTI_FRAME, (50, 1.0), None),
                 ("mono_motion", (1, 1000, 1000), VGA, (100, 0.9), 15.0))


def card_line() -> str:
    """Name and power limit of the card as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "not measured"


def wrapper_us(fn, n=20, warmup=3) -> float:
    """Median time of one eager call of fn by CUDA events, in microseconds."""
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
    return 1e3 * statistics.median(times)


def graph_us(fn, calls=100, replays=7) -> float:
    """Device time of one call of fn without the host: `calls` calls in one
    CUDA graph, replayed `replays` times, the median replay over `calls`."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        keep = [fn() for _ in range(calls)]  # own outputs for every call
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    del keep, graph
    return 1e3 * statistics.median(times) / calls


def busy_us(fn, calls=20):
    """(sum of kernel durations per call in microseconds, kernels per call)
    from the profiler's device rows of `calls` eager calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in rows) / calls, sum(e.count for e in rows) / calls


def measure(fn) -> dict:
    busy, n_kernels = busy_us(fn)
    return {"graph_us": graph_us(fn), "busy_us": busy, "kernels": n_kernels, "wrapper_us": wrapper_us(fn)}


def search_inputs(rng, dev, b, q, n, width, height, radius=None):
    """Queries, radius and targets of one search shape, from `rng`: random
    descriptors with duplicates (ties of the best distance), positions
    uniform over a width x height frame, 10% invalid; each query's radius
    is `radius` px x 1.2 ** its level, or uniform in 5-60 px if None."""
    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch.ops import hamming

    def feats(count):
        words = hamming.words_from_uint32(rng.integers(0, 2**32, (b, count, 8), dtype=np.uint32))
        words[:, 5::7] = words[:, :1]
        xy = np.stack([rng.uniform(0, width, (b, count)), rng.uniform(0, height, (b, count))], -1)
        lvl = rng.integers(0, 8, (b, count))
        valid = rng.uniform(size=(b, count)) > 0.1
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                (words, xy.astype(np.float32), lvl.astype(np.int32), valid)]

    qf, tf = feats(q), feats(n)
    r = rng.uniform(5, 60, (b, q)).astype(np.float32)
    if radius is not None:
        r = (radius * 1.2 ** qf[2].cpu().numpy()).astype(np.float32)
    return qf, torch.from_numpy(r).to(dev), tf


# (name, observations, stereo share) of the tracker's pose optimization: the
# benchmark's 1000 RGB-D slots and the KITTI geometry's 2000 stereo slots.
POSE_SHAPES = (("rgbd", 1000, 0.3), ("kitti", 2000, 0.8))


def pose_inputs(rng, dev, n, stereo_frac, outliers=0.1, noise=0.5, xi=(0.05, -0.03, 0.02, 0.01, -0.02, 0.015),
                invalid=0.05, info_scale=1.0, vo_layout=False):
    """(Tcw0, points, obs, K, bf) of one motion-only pose problem from `rng`:
    n observations of points 3-9 m ahead seen from the pose se3_exp(xi)
    (the start is the identity), `noise` px of noise, a share `outliers` of
    them up to 40 px off, a share `stereo_frac` stereo, octaves 0-7
    (inv_sigma2 = info_scale / 1.44 ** level), a share `invalid` of invalid
    slots; K and bf of the benchmark camera. The map holds 1.5 n points seen
    through a permutation, or with `vo_layout` n points with pt_idx = arange
    (the motion model's explicit positions)."""
    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch.ops import ba, lie

    K = np.array([BENCH["fx"], BENCH["fy"], BENCH["cx"], BENCH["cy"]], np.float32)
    bf = float(np.float32(BENCH["bf"]))
    n_pts = n if vo_layout else n + n // 2
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts), rng.uniform(3, 9, n_pts)], -1)
    idx = np.arange(n) if vo_layout else rng.permutation(n_pts)[:n]
    T = lie.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy().astype(np.float64)
    pc = pts[idx] @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([K[0] * pc[:, 0] / pc[:, 2] + K[2], K[1] * pc[:, 1] / pc[:, 2] + K[3]], -1)
    uv += rng.normal(size=uv.shape) * noise
    bad = rng.uniform(size=n) < outliers
    uv[bad] += rng.uniform(-40, 40, (int(bad.sum()), 2))
    stereo = rng.uniform(size=n) < stereo_frac
    target = np.concatenate([uv, np.where(stereo, uv[:, 0] - bf / pc[:, 2], -1.0)[:, None]], -1)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    obs = ba.Obs(t(np.zeros(n), torch.int32), t(idx, torch.int32), t(target),
                 t(info_scale / 1.44 ** rng.integers(0, 8, n)), t(stereo, torch.bool),
                 t(rng.uniform(size=n) > invalid, torch.bool))
    return torch.eye(4, device=dev), t(pts), obs, t(K), bf


def pose_near_threshold(T, points, obs, K, bf, rel=1e-4):
    """The observations whose chi2 at the pose T, computed in float64 on the
    host, lies within `rel` (relative) of its inlier threshold: where the
    kernel's inlier flags and the plain version's may differ by rounding
    (their sums run in different orders)."""
    import numpy as np
    from orb_slam2v2_1_tpu_torch.ops import ba

    T = T.detach().cpu().double().numpy()
    pw = points.detach().cpu().double().numpy()[obs.pt_idx.cpu().long().numpy()]
    k = K.detach().cpu().double().numpy()
    tgt = obs.target.cpu().double().numpy()
    st = obs.is_stereo.cpu().numpy()
    pc = pw @ T[:3, :3].T + T[:3, 3]
    iz = 1.0 / np.maximum(pc[:, 2], 1e-6)
    u = k[0] * pc[:, 0] * iz + k[2]
    v = k[1] * pc[:, 1] * iz + k[3]
    chi2 = ((u - tgt[:, 0]) ** 2 + (v - tgt[:, 1]) ** 2 + ((u - bf * iz - tgt[:, 2]) * st) ** 2) \
        * obs.inv_sigma2.cpu().double().numpy()
    return np.abs(chi2 / np.where(st, ba.CHI2_STEREO, ba.CHI2_MONO) - 1.0) <= rel


def fast_stage(levels, counts, ocfg):
    """The FAST stage of one frame as `ops.orb.extract_orb` runs it: from the
    pyramid's levels to (yx, response, valid) per level."""
    from orb_slam2v2_1_tpu_torch.ops import fast

    kw = dict(cell=ocfg.cell, border=ocfg.border, threshold=ocfg.fast_threshold,
              min_threshold=ocfg.fast_min_threshold)
    if hasattr(fast, "suppressed_cells_pyramid"):
        cells = fast.suppressed_cells_pyramid(levels, **kw, min_stride=max(counts))
        return fast.select_from_pyramid_cells(cells, counts, ocfg.cell)
    return [fast.select_keypoints(fast.suppressed_score(lvl), n, suppress=False, **kw)
            for lvl, n in zip(levels, counts)]


def main() -> int:
    args = sys.argv[1:]
    opts = {"--root": os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "--out": None}
    while args:
        if args[0] not in opts or len(args) < 2:
            raise SystemExit(__doc__)
        opts[args[0]] = args[1]
        args = args[2:]
    root = os.path.abspath(opts["--root"])
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or ".") != here]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: torch.cuda.is_available() is False; the kernels run on an NVIDIA card only")
    import orb_slam2v2_1_tpu_torch as port

    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) != root:
        raise SystemExit(f"kernel_times: expected the package under {root}, found {port.__file__}")
    from orb_slam2v2_1_tpu_torch import kernels
    from orb_slam2v2_1_tpu_torch.ops import fast, image, matching, orb
    from orb_slam2v2_1_tpu_torch.utils import config, synthetic

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"package {root}\ntorch {torch.__version__} cuda {torch.version.cuda}\n{card}", flush=True)
    kernels.build()
    cfg = config.SlamConfig(**BENCH)
    ocfg = orb.OrbConfig(n_features=cfg.n_features, n_levels=cfg.n_levels, scale=cfg.scale_factor,
                         fast_threshold=cfg.fast_threshold, fast_min_threshold=cfg.fast_min_threshold)
    imgs, _, _ = synthetic.orbit_frames(cfg, 1, device=dev, total=ORBIT_TOTAL)
    levels = [lvl.contiguous() for lvl in image.build_pyramid(imgs[0].contiguous(), cfg.n_levels, cfg.scale_factor)]
    counts = fast.level_feature_counts(cfg.n_features, cfg.n_levels, cfg.scale_factor)

    cases = {}
    if hasattr(kernels, "empty_launch"):
        cases["empty_launch"] = lambda: kernels.empty_launch(dev)
    for lvl in levels:
        cases[f"fast_score_nms map {lvl.shape[0]}x{lvl.shape[1]}"] = lambda lvl=lvl: kernels.fast_score_nms(lvl)
    if hasattr(kernels, "fast_cells_pyramid"):
        cases["fast_score_nms cells pyramid"] = lambda: fast.suppressed_cells_pyramid(
            levels, cell=ocfg.cell, border=ocfg.border, threshold=ocfg.fast_threshold,
            min_threshold=ocfg.fast_min_threshold)
    cases["FAST stage of one frame"] = lambda: fast_stage(levels, counts, ocfg)
    rng = np.random.default_rng(0)
    for name, (b, q, n), frame, (max_dist, ratio), radius in SEARCH_SHAPES:
        qf, r, tf = search_inputs(rng, dev, b, q, n, *frame, radius)
        cases[f"masked_best_two best-two {name} {b}x{q}x{n}"] = (
            lambda qf=qf, r=r, tf=tf: matching.masked_best_two(*qf, r, *tf))
        cases[f"match_projection {name} {b}x{q}x{n}"] = (
            lambda qf=qf, r=r, tf=tf, max_dist=max_dist, ratio=ratio: matching.match_projection(
                *qf, *tf, r, max_dist=max_dist, nn_ratio=ratio))

    if hasattr(kernels, "pose_lm"):
        from orb_slam2v2_1_tpu_torch.ops import ba

        for name, n, stereo_frac in POSE_SHAPES:
            args = pose_inputs(rng, dev, n, stereo_frac)
            T0, pts, obs, K, bf = args
            out = kernels.pose_lm(T0, pts, obs.pt_idx, obs.target, obs.inv_sigma2, obs.is_stereo, obs.valid, K, bf)
            # The LM iterations the kernel ran, by round (where it reports them).
            ran = f" ({'+'.join(map(str, out[3].tolist()))} iterations)" if len(out) > 3 else ""
            cases[f"pose_lm {name} 1x{n}{ran}"] = lambda args=args: ba.pose_optimization(*args)

    results, failed = {}, []
    for name, fn in cases.items():
        try:
            results[name] = measure(fn)
        except Exception as exc:  # a measuring script: report every case, then fail
            failed.append(name)
            print(f"{name}: FAILED {type(exc).__name__}: {exc}", flush=True)
            continue
        m = results[name]
        print(f"{name}: graph {m['graph_us']:.2f} us, kernel rows {m['busy_us']:.2f} us in "
              f"{m['kernels']:.1f} kernels, wrapper-included {m['wrapper_us']:.2f} us", flush=True)
    record = {"root": root, "card": card, "torch": torch.__version__, "cases": results, "failed": failed}
    print(json.dumps(record), flush=True)
    if opts["--out"]:
        os.makedirs(os.path.dirname(os.path.abspath(opts["--out"])), exist_ok=True)
        with open(opts["--out"], "w") as f:
            json.dump(record, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
