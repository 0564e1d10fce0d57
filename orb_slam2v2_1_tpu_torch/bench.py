"""Headline benchmark: end-to-end RGB-D SLAM throughput WITH loop closing.

Port of the repository's `bench.py`, with its legs, configurations, run
counts and JSON keys:

  python -m orb_slam2v2_1_tpu_torch.bench

needs one NVIDIA card and fails at once without one.

Primary metric (the JSON line, the last line of stdout): steady-state
frames/s over the 321-frame orbit sequence that revisits mapped territory,
the median of 3 timed runs after 2 warm-up runs, through the full pipeline:
ORB extraction, motion-model + local-map tracking, keyframe policy, local
mapping/BA, BoW loop detection, Sim3 + essential-graph correction, loop
fusion, and global BA (detached + abortable, overlapped with tracking).
Baseline: the reference's real-time claim of 30 Hz on a desktop i7
(BASELINE.md).

Also in the line:
  - `online_*`: per-frame latency percentiles through the SlamSystem API in
    its production mode (async mapping workers, detached global BA,
    pipelined tracking) on the same orbit at fps=30;
  - `kitti_*`: a KITTI-geometry stereo leg (1241x376, 2000 features, 60
    pairs) in the same mode.
A leg that fails fails the run: no line is printed and the exit code is not
0. The card's name and power limit go to stderr with the log.

Frames are rendered on the card before any clock starts: the compute
pipeline is the metric (the reference's 30 Hz is tracking on frames already
in memory).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from . import device as device_mod
from . import kernel_times
from .models import keyframe_database as kdb
from .models import offline
from .models.loop_closing import LoopCloser
from .models.system import VOCAB_NPZ, Sensor, SlamSystem
from .ops import vocab as vocab_ops
from .utils import synthetic
from .utils.config import SlamConfig

N_FRAMES, CHUNK = 321, 32
ONLINE_FPS = 30.0
KITTI_PAIRS, KITTI_STEP = 60, (0.08, 0.05)  # a forward-lateral dolly, m per frame


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_loop_closer(cfg, device=None, detached=True):
    """The benchmark's loop closer: the package's vocabulary, a database
    sized by the configuration, fixed scale (RGB-D), and the global BA
    detached on its own thread."""
    dev = device_mod.resolve(device)
    vocab = vocab_ops.load_vocabulary(np.load(VOCAB_NPZ), device=dev)
    db = kdb.empty_database(cfg.max_keyframes, cfg.n_features, vocab.n_words, device=dev)
    lc = LoopCloser(vocab, db, fix_scale=True, K=torch.tensor(cfg.K, dtype=torch.float32, device=dev),
                    bf=float(np.float32(cfg.bf)))
    if detached:
        lc.enable_detached_gba()
    return lc


def headline(cfg, imgs, deps, warm=2, runs=3, observe=None):
    """frames/s of `offline.track_sequence_rgbd` with a fresh loop closer
    over the frames (tensors on their device): the median wall of `runs`
    timed runs after `warm` warm-up runs, each run checked (>= 90% tracked,
    >= 1 loop closed, no global-BA thread left). Returns (frames/s, spread
    of the timed walls). `observe(wall, poses, ok, state, loop_closer)` is
    called after each timed run."""
    N = imgs.shape[0]
    dev = imgs.device

    def run():
        lc = make_loop_closer(cfg, device=dev)
        _sync(dev)
        t0 = time.time()
        poses, ok, state = offline.track_sequence_rgbd(imgs, deps, cfg, loop_closer=lc, chunk=CHUNK)
        _sync(dev)
        wall = time.time() - t0
        if lc.gba_runner is not None and lc.gba_runner.running:
            raise AssertionError("a global-BA thread outlived its run")
        return wall, poses, ok, state, lc

    # Warm-up: the loop/GBA pipeline meets new shapes lazily as the map grows.
    for _ in range(warm):
        run()
    walls = []
    for _ in range(runs):
        wall, poses, ok, state, lc = run()
        walls.append(wall)
        n_ok = int(ok.sum())
        if n_ok < N * 0.9:
            raise AssertionError(f"tracking failed: {n_ok}/{N}")
        if lc.n_loops_closed < 1:
            raise AssertionError("no loop closed on the orbit")
        if observe is not None:
            observe(wall, poses, ok, state, lc)
    walls = np.array(walls)
    spread = (walls.max() - walls.min()) / walls.min()
    wall = np.median(walls)  # robust central estimate; spread reported
    runner = lc.gba_runner
    log(
        f"loop-enabled scan: median {wall:.2f}s of "
        f"{[f'{w:.2f}' for w in walls]} (spread {spread * 100:.0f}%) "
        f"for {N} frames, {lc.n_loops_closed} loops closed, {n_ok}/{N} tracked, "
        f"GBA merged={lc.n_gba_merged} aborted={runner.n_aborted if runner else 0}"
    )
    return N / wall, spread


def production_system(cfg, sensor, device=None, **warmup_kw):
    """A `SlamSystem` in the benchmark's production mode (async mapping and
    loop workers, detached global BA, pipelined tracking) after `warmup`.
    Returns (system, warm-up seconds); the caller shuts it down."""
    slam = SlamSystem(config=cfg, sensor=sensor, async_mapping=True, pipelined=True, device=device)
    try:
        t0 = time.time()
        slam.warmup(**warmup_kw)
        _sync(slam.device)
        warm_s = time.time() - t0
    except BaseException:
        slam.shutdown()
        raise
    return slam, warm_s


def timed_frames(track, frames, dt):
    """Feed (a, b) pairs through `track` at timestamps i * dt: per-call
    latencies (ms) and the wall (s) from the first call to the last."""
    lat = []
    t_run = time.time()
    for i, (a, b) in enumerate(frames):
        t0 = time.perf_counter()
        track(a, b, timestamp=i * dt)
        lat.append(time.perf_counter() - t0)
    return np.array(lat) * 1e3, time.time() - t_run


def online_run(slam, frames):
    """The online leg's frames through a production system: `track_rgbd`
    per frame, then `flush()`. Returns the eight `online_*` keys, the
    per-call latencies (ms) and the wall (s, to the last call)."""
    lat, wall = timed_frames(slam.track_rgbd, frames, 1.0 / ONLINE_FPS)
    slam.flush()
    fps = len(frames) / wall
    out = {
        "online_fps": round(fps, 2),
        "online_p50_ms": round(float(np.percentile(lat, 50)), 1),
        "online_p90_ms": round(float(np.percentile(lat, 90)), 1),
        "online_p99_ms": round(float(np.percentile(lat, 99)), 1),
        "online_max_ms": round(float(lat.max()), 1),
        "online_loops": slam.n_loops_closed,
        "online_kf": slam.n_kf_host,
        "online_resets": slam.n_resets,
    }
    log(
        f"online pipelined: {fps:.1f} fps | p50={out['online_p50_ms']} "
        f"p90={out['online_p90_ms']} p99={out['online_p99_ms']} "
        f"max={out['online_max_ms']} ms | kf={slam.n_kf_host} "
        f"loops={slam.n_loops_closed} resets={slam.n_resets}"
    )
    log(f"online stage metrics: {slam.stats()}")
    return out, lat, wall


def online_leg(cfg, frames, device=None):
    """Per-frame latency through the online SlamSystem API in its production
    configuration (the reference's per-frame TrackRGBD with LocalMapping and
    LoopClosing threads, src/System.cc:124-143,424), on the headline's orbit,
    so the run includes keyframes, mapping rounds, loop detection and at
    least one full closure."""
    slam, warm_s = production_system(cfg, Sensor.RGBD, device)
    log(f"online warmup (compile walk) in {warm_s:.1f}s")
    try:
        return online_run(slam, frames)[0]
    finally:
        slam.shutdown()


def kitti_frames(device=None):
    """The KITTI leg's configuration (1241x376, 2000 features; the camera
    rate is 10 fps) and its rectified pairs: a forward-lateral dolly through
    `make_room(default_rng(3))`. Returns (cfg, left, right, ground-truth Tcw)."""
    cfg = SlamConfig(**kernel_times.KITTI)
    left, right, gt = synthetic.stereo_dolly_frames(cfg, range(KITTI_PAIRS), np.random.default_rng(3),
                                                    device=device_mod.resolve(device), dx=KITTI_STEP[0],
                                                    dz=KITTI_STEP[1])
    return cfg, left, right, gt


def kitti_run(slam, frames):
    """The KITTI leg's pairs through a production system: `track_stereo`
    per pair at i * 0.1 s, then `flush()`. Returns the three `kitti_*`
    keys, the per-call latencies (ms) and the wall (s, to the last call)."""
    n = len(frames)
    lat, wall = timed_frames(slam.track_stereo, frames, 0.1)
    slam.flush()
    tracked = sum(1 for e in slam.trajectory.entries if not e.lost)
    out = {
        "kitti_fps": round(n / wall, 2),
        "kitti_p50_ms": round(float(np.percentile(lat, 50)), 1),
        "kitti_p99_ms": round(float(np.percentile(lat, 99)), 1),
    }
    log(
        f"KITTI-geometry stereo (1241x376, 2000 feats, pipelined): "
        f"{out['kitti_fps']} fps, p50={out['kitti_p50_ms']} ms, "
        f"p99={out['kitti_p99_ms']} ms, tracked {tracked}/{n}"
    )
    return out, lat, wall


def kitti_leg(device=None):
    """KITTI-geometry stereo in the online pipelined configuration (the
    reference's KITTI real-time setup)."""
    cfg, left, right, _ = kitti_frames(device)
    slam, warm_s = production_system(cfg, Sensor.STEREO, left.device, gba_buckets=(16, 32))
    log(f"KITTI warmup in {warm_s:.1f}s")
    try:
        return kitti_run(slam, list(zip(left, right)))[0]
    finally:
        slam.shutdown()


def result_line(fps, spread, extra):
    """The benchmark's JSON object: the headline, then the legs' keys."""
    return {
        "metric": "rgbd_slam_fps_with_loop_closing",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 3),
        "spread_pct": round(spread * 100, 1),
        **extra,
    }


def main(device=None):
    dev = device_mod.resolve(device)  # no card: fail before anything is rendered
    if dev.type == "cuda":
        log(f"{torch.cuda.get_device_name(dev)}: {kernel_times.card_line()}")
    cfg = SlamConfig(**kernel_times.BENCH)
    t0 = time.time()
    imgs, deps, _ = synthetic.orbit_frames(cfg, N_FRAMES, device=dev)
    _sync(dev)
    log(f"rendered {N_FRAMES} frames in {time.time() - t0:.1f}s")

    fps, spread = headline(cfg, imgs, deps)
    extra = {}
    # The legs are not caught: a failed leg fails the run.
    extra.update(online_leg(dataclasses.replace(cfg, fps=ONLINE_FPS), list(zip(imgs, deps)), device=dev))
    extra.update(kitti_leg(device=dev))
    print(json.dumps(result_line(fps, spread, extra)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
