#!/usr/bin/env python3
"""Smoke run of the PyTorch port (orb_slam2v2_1_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                # needs one CUDA card; run from the repo root
    python3 chip_smoke.py --profile DIR  # also writes a torch.profiler table of
                                         # frames 0-10, the poses of both paths
                                         # and a table of the loop rounds to DIR

Phases, each of which raises (exit code != 0) on failure:
  1. require CUDA; print torch's version, the card, and nvidia-smi's name and
     power limit;
  2. build the hand-written CUDA kernels from csrc/ (timed as set-up);
  3. both forms of each kernel against their plain PyTorch versions at the
     main path's shapes, on the card, exact: the score map per level, the
     per-cell best corner for the whole pyramid (rendered frame and uniform
     noise, at 640x480 and at the KITTI geometry's 1241x376), (idx, best,
     second) and the finished one-to-one match at the nine search shapes
     (motion model, local map, batched fuse, loop closing's Sim3 search and
     loop fusion, the KITTI geometry's motion model, local map and fuse with
     2000 keypoints, and the monocular motion model at radius 15); kernel 3,
     the tracker's pose optimization (`pose_lm`), against its plain version
     at 1x1000 RGB-D and 1x2000 KITTI observations, within float32 rounding
     (its sums run in another order: pose within 1e-4, inlier flags equal
     away from the chi2 threshold) and bit for bit between two calls. Per
     form: the device time without the host (100 calls in one CUDA graph
     between two events), the wrapper-included time and the plain version's
     (events around one call, median of 20), the bound reckoned from this
     run's inputs, and the empty kernel's launch;
  4. the main path: frames 0-95 of the benchmark's 321-frame RGB-D orbit,
     rendered on the card, through `models.offline.track_sequence_rgbd` at the
     benchmark configuration (640x480, 1000 features, 8 levels, 128 keyframes,
     16384 map points); launch counts of the kernels (fast_score_nms once
     per frame, pose_lm at least twice per tracked frame), tracked share,
     ATE against the orbit's ground truth, frames/s; the first frames are
     also run on the CPU (plain versions) and must agree;
  5. the loop path: all 321 frames of the orbit as one timed run of the
     benchmark's headline, `bench.headline(warm=0, runs=1)`: the same entry
     point with the loop closer of `bench.make_loop_closer` (the package's
     vocabulary, a 128 x 1000 x 10000 database, fixed scale, detached global
     BA) in chunks of 32 frames: at least 90% of frames tracked, at least one
     loop closed, finite poses, ATE within its bound, kernel 2 launched more
     often than frames were tracked, no global-BA thread left running;
  6. the online RGB-D path: `models.system.SlamSystem(sensor=RGBD)` in sync
     mode at the benchmark configuration, frame by frame through `track_rgbd`:
     orbit frames 0-69, three black frames, frames 66-95, then frames 30-32
     (146 deg from the last view: only relocalization recovers them). Lost on
     every black frame, tracking again on the first or second replayed frame
     without a reset, relocalized within frames 30-32, >= 90% of the other
     frames tracked, ATE within its bound; the batched float64 eigen solve of
     the PnP RANSAC on the card gives the CPU's inlier set;
  (phases 7-10 and 14-16 track through `evaluate.run_sequence`, the port's
  accuracy harness, and take its tracked count and ATE)
  7. the stereo dolly: `evaluate.py`'s stereo_dolly through
     `SlamSystem(sensor=STEREO).track_stereo` (75 rectified pairs of
     `make_room(default_rng(3))`, 5 cm sideways and 4 cm forward a frame,
     th_depth=100): 75/75 tracked, ATE <= 0.035 x 1.05 m (evaluate.py's
     gate), fast_score_nms launched twice per frame; the first pair's stereo
     frame equals the CPU's;
  8. the KITTI geometry: bench.py's KITTI leg (1241x376, 2000 features, 64
     keyframes, 60 pairs, 8 cm sideways and 5 cm forward a frame) in sync
     mode: at least the reference's 51 frames tracked (the camera leaves the
     room at frame 50), ATE within its bound;
  9. evaluate.py's clean_desk_rgbd: `make_desk(default_rng(7))` along
     `desk_trajectory(150)` (made relative to its first camera) through
     `SlamSystem(sensor=RGBD).track_rgbd` at evaluate.py's configuration
     (the benchmark's with th_depth=40): ATE within evaluate.py's gate, at
     least the reference's share of frames tracked;
 10. evaluate.py's clean_mono: the same desk along `lateral_trajectory(100)`
     through `SlamSystem(sensor=MONOCULAR).track_monocular` (bf=0): the
     two-view initialization, then every frame tracked, at least the
     reference's tracked count less 2, scale-aligned ATE within evaluate.py's
     gate; kernel 2's motion-model search runs at radius 15;
 11. bench.py's online leg in its production mode, through the port's
     `bench.production_system` and `bench.online_run`: all 321 orbit frames
     at the benchmark configuration with fps=30 through
     `SlamSystem(sensor=RGBD, async_mapping=True, pipelined=True)`: `warmup()`
     (timed as set-up), `track_rgbd` per frame, `flush()`, `stats()`,
     `shutdown()`. At least 90% of the frames tracked, every frame past 253
     (where the reference's run of this mode crashed on the TPU) decided, at
     least one loop closed, finite poses, the ATE over the first 240 frames
     within twice the reference's largest in this mode there (its runs of
     this mode fail after 250-284 frames) and over all 321 frames within
     twice the reference's sync mode on them (2 x 0.2746 m), no worker
     exception, no
     global-BA thread alive after `shutdown`, nothing in flight after
     `flush`, and kernel 2 launched from the mapping worker's thread. One
     line: per-call latency p50/p90/p99/max, `map_ms_p50`, frames/s, host
     reads per frame by the tracker and by the workers, launches by thread
     (the tracker's pose_lm at least twice per tracked frame, here and in
     phase 12);
 12. bench.py's KITTI leg in the same mode (`bench.kitti_frames`,
     `production_system`, `kitti_run`), after `warmup(gba_buckets=(16, 32))`:
     at least the reference's 51/60 tracked, ATE within 2 x 0.01137 m; then
     bench.py's JSON line, assembled by `bench.result_line` from phase 5's
     run and the legs of phases 11-12, holds every key of bench.py's;
 13. the map of phase 11 saved with `save_map` (its arrays equal `to_numpy` of
     the live map) and loaded by a fresh system of the same mode, which
     starts LOST; on every 10th orbit frame the loaded map relocalizes as
     the live one does, and a restart at the first of those frames that
     only relocalization can recover relocalizes within three frames, its
     motion from the keyframe it relocalized on within 0.10 m and 5 deg of
     the ground truth's;
 14. evaluate.py's adv_clutter_rgbd: `make_adversarial(default_rng(21))`
     along `desk_trajectory(150, extent=0.55)`, degraded as evaluate.py
     degrades it (exposure steps, motion blur, noise, one generator), at
     phase 9's configuration in sync mode: evaluate.py's gate against phase
     9's ATE of this run (ATE <= max(3 x clean, 0.05 m), tracked share after
     the first pose >= 0.85) and at least the reference's tracked count less 2;
 15. adv_mono: `make_adversarial(default_rng(22), max_tilt_deg=35)` along
     `lateral_trajectory(100, extent=0.9)`, noise from `default_rng(33)`,
     bf=0, scale-aligned; the gate against phase 10;
 16. adv_stereo_dolly: phase 7's room and dolly with the degradation drawn
     from `default_rng(43)`; the gate against phase 7; fast_score_nms twice
     per pair;
 17. the command line: 100 frames of the desk sweep written as a TUM RGB-D
     directory (RGB and 16-bit depth PNGs, depth stamps 4 ms late, the
     ground truth) with a settings file, then `python -m
     orb_slam2v2_1_tpu_torch.run_slam` run on it as a subprocess on the card
     in its default async mode with `--save-map --ply --viz-dir`: exit 0, the
     printed ATE within twice the reference's CLI on the same directory, the
     map loads in a fresh system, the PLY holds its valid points, the PNGs
     exist, the kernels' launches (printed by the subprocess) one FAST per
     frame; `StereoRectifier` at EuRoC's calibration and `backproject` on the
     card against the CPU (1e-3 gray levels, 1e-5 m and the same NaN rows);
 18. two sessions on one `MapServerNode` (loopback, maps on the card):
     session 1 streams desk frames 0-69 from a sync `SlamSystem`, session 2
     frames 50-119 in its own world; the operator lists both; session 2's
     `fetch_server_map(merge_with=1)` merges session 1's map into its world
     on the server's connection thread (kernel 2 launched there, counted
     under the role "server"): the merge accepted, the adopted map holding
     both sessions' keyframes and fused points, session 1's keyframe centers
     within twice the reference's RMS from the truth in session 2's world,
     session 2 LOST; then frames 20-22, which only session 1 saw: session 2
     is back from LOST on session 1's part of the map (its frame matched to
     at least 20 of session 1's points; a relocalization, if it took one, on
     a keyframe of session 1), the first pose within 0.10 m and 5 deg of the
     truth; no exception on either stream's worker.
 19. the bundle adjustment sharded over a device mesh (`parallel/dist_ba.py`),
     on meshes of virtual shards of the one card: (a) the JAX package's
     production-scale problem (128 keyframes, 16384 points, 65536 stereo
     observations, seed 0) through the full LM schedule (cg_iters=24) on 1,
     2 and 4 shards and through a world-size-1 NCCL group: every final cost
     within 1% of `ops.ba.bundle_adjust`'s on the card, finite, the NCCL run
     equal to its in-process twin; ms per 3-iteration LM chunk by mesh size
     and on one device; (b) phase 11's configuration in sync mode with its
     loop closer over all 321 orbit frames through `SlamSystem(mesh=4
     shards)`: at least 90% tracked, a loop closed, ATE within twice the
     reference's sync mode (0.2746 m), every local BA round and every inline
     global BA through the mesh; (c) the detached global-BA runner on 4
     shards on (b)'s final map: no abort, the merged map's cost within 1% of
     the single-device runner's on the same snapshot; (d) clean_desk_rgbd in
     async mode on 2 shards: 150/150 tracked, ATE within evaluate.py's gate,
     the mapping worker's windows solved on the mesh.
 20. the accuracy harness's entry point: `python -m
     orb_slam2v2_1_tpu_torch.evaluate --quick --frames 40 --out
     build/chip_smoke/EVAL.json` as a subprocess on the card: exit 0, every
     gate passed, each leg's tracked count at least its floor, fast_score_nms
     once per frame (the subprocess prints its launches); each leg's ATE
     against its bound and the wall time.
 21. the RANSAC draws of `ops/prng.py` (the reference's Threefry stream and
     Gumbel top-k, from the reference's keys) on the card against the CPU,
     bit for bit: the 32-bit words and the hypothesis sets of each sampler
     at the shapes of the paths that draw (relocalization's PnP, loop
     closing's Sim3, the server's merge, both halves of the two-view
     initializer's key, the KITTI geometry's PnP, a 4096-wide mask); ms,
     device time and launches per draw.
The second-to-last line is a JSON object of per-kernel results; the last line
is {"ok": true, "device": {...}}.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N_FRAMES = 96
# ATE bound (metres): twice the JAX reference's ATE on the same 96 frames,
# 0.1431 m measured with the JAX package on the CPU (rigid-aligned). Without
# loop closing the reference itself misses the 0.02 m bound on this orbit.
ATE_BOUND = 2 * 0.1431
CPU_CHECK_FRAMES = 6
LOOP_FRAMES, LOOP_CHUNK = 321, 32
# ATE bound of the loop path (metres): twice the JAX reference's ATE on the
# same 321 frames with its loop closer, 0.3542 m, measured with
# `tests/torch_reference_orbit.py` (JAX on the CPU of an H100 machine: 321/321
# tracked, 33 keyframes, 1 loop closed, 1 global BA merged). The orbit turns
# in place, so this ATE is the scatter of the estimated centers about a point.
LOOP_ATE_BOUND = 2 * 0.3542
# Phase 6: orbit frame indices fed to SlamSystem.track_rgbd, None = a black
# frame (zero image and depth).
ONLINE_SEQUENCE = list(range(70)) + [None] * 3 + list(range(66, 96)) + [30, 31, 32]
BLACKOUT, REPLAY, FAR = slice(70, 73), 73, slice(103, 106)
# ATE bound of the online path (metres, `utils.trajectory.ate_rmse` without
# scale over the tracked frames): twice the JAX reference's on the same
# sequence, 0.1220 m, measured with `tests/torch_reference_orbit.py --online`
# (JAX on the CPU of an H100 machine: 103/106 poses, 7 keyframes before the
# blackout, 1 relocalization, 0 resets).
ONLINE_ATE_BOUND = 2 * 0.1220
# Phase 7: evaluate.py's stereo_dolly (its gate: BASELINE.md's EuRoC MH_01
# stereo ATE x 1.05).
DOLLY_FRAMES, DOLLY_STEP = 75, (0.05, 0.04)
DOLLY_ATE_BOUND = 0.035 * 1.05
# Phase 8: bench.py's KITTI leg. The dolly takes the camera through the
# room's right wall (x = 4 m) at frame 50, so the reference tracks 51 of the
# 60 frames; the port is held to that count and to twice the reference's
# ATE, 0.01137 m (`tests/torch_reference_orbit.py --stereo`, JAX on the CPU
# of an H100 machine: 51/60, 12 keyframes). The stereo dolly's reference:
# 75/75, 8 keyframes, ATE 0.01068 m.
KITTI_FRAMES, KITTI_STEP = 60, (0.08, 0.05)
KITTI_MIN_TRACKED = 51
KITTI_ATE_BOUND = 2 * 0.01137
# Phases 9 and 10: evaluate.py's clean desk legs and their gates, BASELINE.md's
# TUM fr1/desk RGB-D ATE and fr1/xyz monocular ATE (scale-aligned) x 1.05.
# The reference on the same frames (`tests/torch_reference_orbit.py --desk`,
# JAX on the CPU of an H100 machine): clean_desk_rgbd 150/150 tracked, 10
# keyframes, ATE 0.007186 m; clean_mono 98/100 (the two-view initialization
# on frame 2, every later frame tracked), 14 keyframes, ATE 0.003705 m
# scale-aligned. Their tracked counts are the port's floors.
DESK_FRAMES, MONO_FRAMES = 150, 100
DESK_ATE_BOUND, MONO_ATE_BOUND = 0.016 * 1.05, 0.009 * 1.05
DESK_REF_TRACKED, MONO_REF_TRACKED = 150, 98
# Phases 11-12: bench.py's online and KITTI legs in its production mode
# (async mapping and loop workers, pipelined tracking). The online leg runs
# the benchmark configuration with fps=30 (bench.py:251) and timestamps i/30.
ASYNC_FPS = 30.0
# The reference's run of this mode crashed on the TPU at frame 253, after the
# loop closure (VERDICT.md:19-21); the port must decide every frame past it.
REF_CRASH_FRAME = 253
# The reference on the same frames (`tests/torch_reference_orbit.py --async`,
# JAX on the CPU of an H100 machine, three runs): its async + pipelined
# online leg fails in every run after 250-284 frames, once it has closed a
# loop ("Buffer has been deleted or donated": the loop correction donates the
# map snapshot the tracker still holds), as it did on the TPU at frame 253.
# So the port is held to it on the frames every run decided: the ATE over the
# first ASYNC_PREFIX frames, within twice the reference's largest there.
# Over all 321 frames the reference has only its sync mode to show: 321/321,
# 20 keyframes, 1 loop, ATE 0.2746 m, reported beside the port's (another
# mode, so not a bound). Its KITTI leg in this mode: 51/60, 7 keyframes, ATE
# 0.005577 m in all three runs (phase 12 keeps the sync bounds of phase 8).
ASYNC_PREFIX = 240
ONLINE_ASYNC_REF_PREFIX_ATE = 0.2862  # its three runs: 0.2862, 0.2503, 0.2558 (failed after 266, 284, 250 frames)
ONLINE_ASYNC_ATE_BOUND = 2 * ONLINE_ASYNC_REF_PREFIX_ATE
ONLINE_SYNC_REF_ATE = 0.2746
# Over all 321 frames phase 11 is held to twice the reference's sync mode on
# them: the port's run of this mode goes on past the frames where the
# reference's fails, and its last segment must stay on the orbit.
ONLINE_ASYNC_FULL_ATE_BOUND = 2 * ONLINE_SYNC_REF_ATE
# Phase 13: the loaded map must relocalize as the live one does. Every
# RELOC_PROBE_STEP-th orbit frame is relocalized (`relocalization.relocalize`,
# the tracker's own call) in phase 11's live map and in the loaded one, each
# with the BoW database a load builds (the live database lacks the initial
# keyframe, which the loop closer never receives): the same outcome,
# candidate and matches, and poses within RELOC_SAME_TCW of each other (the
# same computation on equal arrays). Then a fresh load is fed the first probe frame that the live map
# relocalizes and whose phase-11 view is turned more than RELOC_MIN_TURN_DEG
# from both the map's origin (the pose a loaded system seeds its first frame
# with) and the saved reference keyframe, so that only relocalization can
# recover it, and the RELOC_TRIES - 1 frames after it: it must relocalize
# within them, and its pose relative to the keyframe it relocalized on must
# lie within RELOC_POSE_BOUND of the ground truth's between the two frames
# (the orbit turns 2.24 deg a frame). Not against phase 11's pose of the
# frame: the orbit's map is not one rigid whole after its loop closure (phase
# 11's ATE is 0.2-0.5 m, the reference's 0.27 m in sync mode), and a view the
# orbit passed twice may be relocalized on the other pass's keyframe, whose
# place in the map differs by as much. Frames the live map does not relocalize are
# counted, not bounded: where a view is dominated by one wall, the reference's
# six-point DLT hypotheses are ill-conditioned and the pose is found or not by
# the draw, in the reference as in the port (PERF.md).
RELOC_PROBE_STEP = 10
RELOC_SAME_TCW = 1e-4
RELOC_MIN_TURN_DEG = 60.0
RELOC_TRIES = 3
RELOC_POSE_BOUND = (0.10, 5.0)  # m, deg: about two frames of the turn
# Phases 14-16: evaluate.py's adversarial legs and its gate (evaluate.py:288-304):
# ATE <= max(3 x the clean twin's ATE, 0.05 m), tracked share after the first
# pose >= 0.85. The reference on the same frames (`python evaluate.py --cpu`,
# JAX on the CPU of an H100 machine): adv_clutter_rgbd 150/150, 17 keyframes,
# ATE 0.0236 m; adv_mono 75/100 (the first pose at frame 25), 10 keyframes,
# ATE 0.00497 m scale-aligned; adv_stereo_dolly 75/75, 8 keyframes, ATE
# 0.03131 m. The port must track at least its count less 2.
ADV_ATE_FLOOR, ADV_MIN_POST_INIT = 0.05, 0.85
ADV_REF = {"adv_clutter_rgbd": (150, 0.0236), "adv_mono": (75, 0.00497), "adv_stereo_dolly": (75, 0.03131)}
# Phase 17: the CLI on CLI_FRAMES frames of the desk sweep written as a TUM
# directory; its ATE within twice the reference's CLI on the same directory
# (written from the CPU's renders) in the same async mode:
# `tests/torch_reference_cli_server.py --cli` (JAX on the CPU of an H100
# machine): exit 0, ATE 0.0056 m.
CLI_FRAMES, CLI_TIMEOUT_S = 100, 300
CLI_REF_ATE = 0.0056
# Phase 18: session 1 streams desk sweep frames SESSION_1, session 2 frames
# SESSION_2 (both [first, end)); session 2 then sees REVISIT, which only
# session 1 saw. Session 1's keyframe centers in the merged map are held
# within twice the reference's RMS from the truth on the same sessions'
# deltas: `tests/torch_reference_cli_server.py --server DIR --keys 10` (JAX on
# the CPU of an H100 machine, on the sessions this phase streamed): the
# merge accepted for every key, RMS 0.0062-0.0300 m by the Sim3 RANSAC's key,
# median 0.01654 m (the port given the reference's sets of key 0 gives its
# 0.006234 m). In the reference, as in the port, the revisit frames come
# back by tracking against the adopted map's reference keyframe, without a
# relocalization.
SESSION_1, SESSION_2, REVISIT = (0, 70), (50, 120), (20, 23)
SERVER_REF_CENTER_RMS = 0.01654
# Phase 19: the bundle adjustment sharded over a mesh of virtual shards of
# the one card. (a) The JAX package's production-scale problem
# (`__graft_entry__.py`: C=128 keyframes, P=16384 points, O=65536 stereo
# observations, seed 0; `utils.synthetic.ba_problem` draws it) through the
# full LM schedule with cg_iters=24 on meshes of MESH_SHARDS shards and once
# through a world-size-1 NCCL group; each final cost within GBA_COST_REL of
# `ops.ba.bundle_adjust` on the card (the reference's own bound,
# `__graft_entry__.py:96-100`), the NCCL run equal to its in-process twin.
# (b) phase 11's configuration in sync mode with its loop closer over all 321
# orbit frames through `SlamSystem(mesh=[card] * MESH_SYNC_SHARDS)`: every
# local BA round and every inline global BA through the mesh, phase 11's
# tracked share and loop floor, the ATE within twice the reference's sync
# mode on the same frames. (c) the detached runner on a mesh of the same
# size on (b)'s final map: no abort, the merged map's cost within
# GBA_COST_REL of the single-device runner's on the same snapshot. (d)
# phase 9's clean_desk_rgbd in async mode on a mesh of MESH_ASYNC_SHARDS
# shards: 150/150 tracked, ATE within evaluate.py's gate, the mapping worker's
# windows solved through the mesh.
MESH_SHARDS = (1, 2, 4)
GBA_PROBLEM = (128, 16384, 65536)
GBA_CG_ITERS, GBA_COST_REL, CHUNK_REPEATS = 24, 0.01, 3
MESH_SYNC_SHARDS, MESH_ASYNC_SHARDS = 4, 2
MESH_DEVICE, GROUP_BACKEND = "cuda:0", "nccl"  # a rehearsal on the CPU sets "cpu" and "gloo"
MESH_SYNC_ATE_BOUND = 2 * ONLINE_SYNC_REF_ATE
# After phase 12: the keys of bench.py's JSON line (bench.py:139-148,
# 209-213, 260-271), which the line assembled from phases 5, 11 and 12 by
# `bench.result_line` must hold.
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "spread_pct", "online_fps", "online_p50_ms",
              "online_p90_ms", "online_p99_ms", "online_max_ms", "online_loops", "online_kf", "online_resets",
              "kitti_fps", "kitti_p50_ms", "kitti_p99_ms")
# Phase 20: `python -m orb_slam2v2_1_tpu_torch.evaluate` with EVAL_QUICK_ARGS
# as a subprocess on the card: exit 0, every gate passed, and per leg at
# least EVAL_QUICK_MIN_TRACKED frames tracked: the rules of phases 9, 10 and
# 14-15 at 40 frames, against the reference's counts there (`python
# evaluate.py --cpu --quick --frames 40`, JAX on the CPU of an H100 machine:
# 40/40, 40/40, 39/40, 28/40): the clean desk every frame, the other legs
# the reference's count less 2. adv_mono's two-view initialization succeeds
# at frame 12 only with the reference's draws (`tests/torch_mono_init_probe.py
# --frames 40 --card`), which the port now draws on the card too.
EVAL_QUICK_ARGS, EVAL_QUICK_TIMEOUT_S = ("--quick", "--frames", "40"), 600
EVAL_QUICK_MIN_TRACKED = {"clean_desk_rgbd": 40, "adv_clutter_rgbd": 38, "clean_mono": 37, "adv_mono": 26}
# Phase 21: (name, key seed, sampler, keypoints) of each draw held against the
# CPU; the seeds follow the reference's formulas (relocalization frame_id * 97
# + kf, loop closing kf_id * 131 + cand, the server's key(0), the two-view
# initializer's key(frame_id), split), the widths the benchmark's 1000
# keypoints, the KITTI geometry's 2000, and 4096. A third of the entries valid.
DRAWS = (("reloc_pnp", 40 * 97 + 3, "pnp", 1000), ("loop_sim3", 16 * 131 + 0, "sim3", 1000),
         ("merge_sim3", 0, "sim3", 1000), ("two_view_h", 12, "two_view_h", 1000),
         ("two_view_f", 12, "two_view_f", 1000), ("kitti_pnp", 30 * 97 + 5, "pnp", 2000),
         ("wide_pnp", 7 * 97 + 1, "pnp", 4096))


def log(*a):
    print(*a, flush=True)


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


# Rates the bounds are reckoned with: the H100's memory rate and its float32
# rate outside the tensor cores for operations that are not multiply-adds
# (half of 67 TFLOP/s, which counts a multiply-add as two).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 33.5e12
# Operations per pixel of fast_score_nms: 16 subtractions, 64 mins + 64 maxes
# for the 9-windows in doubling form, 32 to reduce them, 9 for the NMS.
FAST_OPS_PER_PIXEL = 185
# Operations of masked_best_two: the window, level and validity test per
# (valid query, target) pair; 8 XORs, 8 popcounts and their sum for a pair
# that passes it.
SEARCH_OPS_PER_PAIR, SEARCH_OPS_PER_CANDIDATE = 8, 27
# Operations of pose_lm (a multiply-add counted once), per observation: an
# LM iteration's pass at T (transform 12, projection and residuals 11, chi2
# and Huber 8, weight and cost 7, the 18 Jacobian entries 28, and per
# residual row 6 weighted entries, 21 of H and 6 of g: 99) and its pass at
# T_new (35), about 200; a round's inlier gate about 30. Bytes: index,
# point, target, inv_sigma2 and two flags read and the mask written, 35 an
# observation.
POSE_OPS_PER_OBS_ITER, POSE_OPS_PER_OBS_ROUND, POSE_BYTES_PER_OBS = 200, 30, 35


def bound(n_bytes, n_ops):
    """(least time in ms, "bytes" or "operations") for work that must move
    n_bytes and do n_ops on the card."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def timed(kt, name, shape, kernel_fn, plain_fn, n_bytes, n_ops, floor_ms, caller=None):
    """One form at one shape: device time of the kernel (graph), its
    wrapper-included time and the plain version's (events), and the bound."""
    ms, wrapper_ms, plain_ms = kt.graph_us(kernel_fn) / 1e3, kt.wrapper_us(kernel_fn) / 1e3, kt.wrapper_us(plain_fn) / 1e3
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"{name}{f' ({caller})' if caller else ''} {shape}: equal; device {ms:.4f} ms, with wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by}), empty launch {floor_ms:.5f} ms")
    return {"form": name, **({"caller": caller} if caller else {}), "shape": shape, "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_fast(kt, img, noise, cfg, ocfg, floor_ms, label=""):
    """Kernel 1, both forms, exact: the score map per level, and cell_best /
    cell_arg for the whole pyramid on the rendered frame and on noise;
    `label` names a geometry other than the benchmark's."""
    import torch
    from orb_slam2v2_1_tpu_torch import kernels
    from orb_slam2v2_1_tpu_torch.ops import fast, image

    rank = dict(cell=ocfg.cell, border=ocfg.border, threshold=ocfg.fast_threshold, min_threshold=ocfg.fast_min_threshold)

    def pyramid(x):
        return [lvl.contiguous() for lvl in image.build_pyramid(x, cfg.n_levels, cfg.scale_factor)]

    def plain_cells(lv):
        return [fast.rank_cells(fast.nms3(fast.fast_score(lvl)), **rank) for lvl in lv]

    levels, shapes = pyramid(img), []
    for lvl in levels:
        got = kernels.fast_score_nms(lvl)
        ref = fast.nms3(fast.fast_score(lvl))
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"fast_score_nms differs from nms3(fast_score) at {tuple(lvl.shape)}")
        shapes.append(timed(kt, "fast_score_nms map" + label, list(lvl.shape), lambda: kernels.fast_score_nms(lvl),
                            lambda: fast.nms3(fast.fast_score(lvl)), 8 * lvl.numel(),
                            FAST_OPS_PER_PIXEL * lvl.numel(), floor_ms))
    for name, lv in (("rendered", levels), ("noise", pyramid(noise))):
        got = fast.suppressed_cells_pyramid(lv, **rank)
        ref = plain_cells(lv)
        torch.cuda.synchronize()
        n_cells = n_strong = n_empty = 0
        for l, (lvl, (rb, ra)) in enumerate(zip(lv, ref)):
            gb, ga = got.level(l)
            if not (torch.equal(gb, rb) and torch.equal(ga, ra) and not got.best[l, gb.numel():].any()):
                raise AssertionError(f"fast_score_nms cell form differs from rank_cells at {tuple(lvl.shape)} ({name})")
            n_cells, n_strong, n_empty = n_cells + rb.numel(), n_strong + int((rb >= 1e4).sum()), n_empty + int((rb == 0).sum())
        log(f"fast_score_nms cells{label}, {name} frame: equal over {len(lv)} levels, {n_cells} cells, "
            f"{n_strong} with a strong corner, {n_empty} empty")
    pixels = sum(lvl.numel() for lvl in levels)
    cells = sum(ch * cw for ch, cw in got.grids)
    main = timed(kt, "fast_score_nms cells" + label, [list(lvl.shape) for lvl in levels],
                 lambda: fast.suppressed_cells_pyramid(levels, **rank), lambda: plain_cells(levels),
                 4 * pixels + 12 * cells, FAST_OPS_PER_PIXEL * pixels, floor_ms)
    return {"max_abs_err": 0.0, **{k: main[k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")},
            "shapes": shapes + [main]}


def check_match(kt, dev, rng, floor_ms):
    """Kernel 2, both forms, exact, at the nine search shapes of the paths."""
    import torch
    from orb_slam2v2_1_tpu_torch.ops import matching

    shapes = []
    for name, (b, q, n), frame, (max_dist, ratio), radius in kt.SEARCH_SHAPES:
        qf, r, tf = kt.search_inputs(rng, dev, b, q, n, *frame, radius)
        idx, best, second = matching.masked_best_two(*qf, r, *tf)
        ridx, rbest, rsecond = matching.masked_best_two_plain(*qf, r, *tf)
        got = matching.match_projection(*qf, *tf, r, max_dist=max_dist, nn_ratio=ratio)
        ref = matching.match_projection_plain(*qf, *tf, r, max_dist=max_dist, nn_ratio=ratio)
        torch.cuda.synchronize()
        if not (torch.equal(best, rbest) and torch.equal(second, rsecond) and torch.equal(idx, ridx)):
            raise AssertionError(f"masked_best_two differs from the plain version at {(b, q, n)}")
        if not (torch.equal(got.ok, ref.ok) and torch.equal(got.dist, ref.dist)
                and torch.equal(got.idx[ref.ok], ref.idx[ref.ok])):
            raise AssertionError(f"match_projection differs from the plain version at {(b, q, n)}")
        pre_ok = matching._ratio_ok(rbest, rsecond, max_dist, ratio)
        mask = (matching.window_mask(qf[1], tf[1], r) & matching.level_mask(qf[2], tf[2], -1, 1)
                & qf[3][..., :, None] & tf[3][..., None, :])
        candidates = int(mask.sum())
        del mask
        log(f"masked_best_two {name} {(b, q, n)}: both forms equal; {float((rbest < matching.BIG).float().mean()):.2f} "
            f"of queries have a candidate, {candidates} candidate pairs, {int(pre_ok.sum())} pass the tests, "
            f"{int(ref.ok.sum())} keep their target")
        n_ops = SEARCH_OPS_PER_PAIR * int(qf[3].sum()) * n + SEARCH_OPS_PER_CANDIDATE * candidates
        in_bytes = b * q * (32 + 8 + 4 + 1 + 4) + b * n * (32 + 8 + 4 + 1)
        shapes.append(timed(kt, "masked_best_two best-two", [b, q, n],
                            lambda: matching.masked_best_two(*qf, r, *tf),
                            lambda: matching.masked_best_two_plain(*qf, r, *tf),
                            in_bytes + b * q * 16, n_ops, floor_ms, caller=name))
        shapes.append(timed(kt, "masked_best_two match", [b, q, n],
                            lambda: matching.match_projection(*qf, *tf, r, max_dist=max_dist, nn_ratio=ratio),
                            lambda: matching.match_projection_plain(*qf, *tf, r, max_dist=max_dist, nn_ratio=ratio),
                            in_bytes + b * q * 13, n_ops, floor_ms, caller=name))
    main = shapes[3]  # the local-map search in the match form: two of them per tracked frame
    return {"max_abs_err": 0.0, **{k: main[k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")},
            "shapes": shapes}


def check_pose(kt, dev, rng, floor_ms):
    """Kernel 3 against the plain version on the card at the main path's
    widths (1000 RGB-D slots, 2000 KITTI slots): the pose within 1e-4, the
    inlier masks equal but where chi2 at the plain pose lies within 1e-4
    (relative) of its threshold, the count that of the mask, two calls bit
    for bit equal (the sums run in another order than the plain version's,
    in a fixed one). The bound counts the iterations the kernel itself ran
    (its fourth output), logged beside the plain version's."""
    import torch
    from orb_slam2v2_1_tpu_torch import kernels, sync
    from orb_slam2v2_1_tpu_torch.ops import ba

    shapes = []
    for name, n, stereo_frac in kt.POSE_SHAPES:
        args = kt.pose_inputs(rng, dev, n, stereo_frac)
        T0, pts, obs, K, bf = args
        flat = (T0, pts, obs.pt_idx, obs.target, obs.inv_sigma2, obs.is_stereo, obs.valid, K, bf)
        reads = sync.COUNT["syncs"]
        ref_T, ref_mask, ref_n = ba.pose_optimization_plain(*args)
        plain_iterations = sync.COUNT["syncs"] - reads
        got, again = ba.pose_optimization(*args), ba.pose_optimization(*args)
        ran = kernels.pose_lm(*flat)[3].cpu().tolist()
        torch.cuda.synchronize()
        near = kt.pose_near_threshold(ref_T, pts, obs, K, bf)
        differ = (got[1] != ref_mask).cpu().numpy()
        err = float((got[0] - ref_T).abs().max())
        if not (all(torch.equal(a, b) for a, b in zip(got, again)) and err <= 1e-4
                and not (differ & ~near).any() and int(got[2]) == int(got[1].sum())):
            raise AssertionError(f"pose_lm differs from pose_optimization_plain at {name} 1x{n}: pose {err:.2e}, "
                                 f"{int(differ.sum())} inlier flags ({int((differ & ~near).sum())} off the threshold)")
        iterations = sum(ran)
        log(f"pose_lm {name} 1x{n}: pose within {err:.2e}, {int(got[2])} inliers (plain {int(ref_n)}), "
            f"{int(differ.sum())} flags at the threshold, LM iterations by round {ran} ({iterations}; "
            f"the plain version {plain_iterations})")
        n_ops = POSE_OPS_PER_OBS_ITER * n * iterations + POSE_OPS_PER_OBS_ROUND * n * 4
        shapes.append(timed(kt, "pose_lm", [1, n], lambda args=args: ba.pose_optimization(*args),
                            lambda args=args: ba.pose_optimization_plain(*args),
                            POSE_BYTES_PER_OBS * n + 148, n_ops, floor_ms, caller=name))
        shapes[-1].update(max_abs_err=err, iterations=iterations, iterations_by_round=ran,
                          plain_iterations=plain_iterations, us_per_iteration=1e3 * shapes[-1]["ms"] / iterations)
    main = shapes[0]
    return {"max_abs_err": max(sh["max_abs_err"] for sh in shapes),
            **{k: main[k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")}, "shapes": shapes}


def orbit_ate(poses, ok, gt):
    """(rigid-aligned ATE, first-frame anchored ATE) of the tracked frames."""
    import numpy as np

    gt_rel = np.stack([g @ np.linalg.inv(gt[0]) for g in gt])  # ground truth, world = first camera
    c_est, c_gt = centers(poses), centers(gt_rel)
    return ate_rigid(c_est[ok], c_gt[ok]), float(np.sqrt(np.mean(np.sum((c_est[ok] - c_gt[ok]) ** 2, axis=1))))


def run_loop_path(imgs, deps, gt, cfg, card):
    """Phase 5: the 321 frames with loop closing, as one timed run of the
    benchmark's headline (`bench.headline` with no warm-up run, its loop
    closer from `bench.make_loop_closer`). Returns the record that goes into
    the kernels line, the launch counts, the poses, and the headline's
    (frames/s, spread)."""
    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch import bench, kernels, sync

    n = imgs.shape[0]
    runs = []
    kernels.reset_launch_counts()
    sync.reset()
    torch.cuda.synchronize()
    headline = bench.headline(cfg, imgs, deps, warm=0, runs=1, observe=lambda *run: runs.append(run))
    wall, poses, ok, state, closer = runs[0]
    launches = dict(kernels.LAUNCHES)
    syncs = sync.COUNT["syncs"]
    runner = closer.gba_runner

    if poses.shape != (n, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"loop path poses: shape {poses.shape}, finite {np.isfinite(poses).all()}")
    if not (torch.isfinite(state.kf_pose).all() and torch.isfinite(state.mp_pos).all()):
        raise AssertionError("loop path: the map is not finite")
    ate, ate_anchored = orbit_ate(poses, ok, gt)
    rec = {"frames": n, "chunk": LOOP_CHUNK, "tracked": int(ok.sum()), "keyframes": int(state.kf_valid.sum()),
           "map_points": int(state.mp_valid.sum()), "loops_closed": closer.n_loops_closed,
           "closures": closer.closures, "detect_suppressed": closer.n_detect_suppressed, "gba_runs": runner.n_runs,
           "gba_merged": closer.n_gba_merged, "gba_aborted": runner.n_aborted,
           "gba_solve_ms": list(runner.solve_ms), "gba_chunk_ms": list(runner.chunk_ms),
           "ate_m": ate, "ate_anchored_m": ate_anchored, "ate_bound_m": LOOP_ATE_BOUND, "wall_s": wall,
           "fps": n / wall, "host_syncs": syncs, "launches": launches, "card": card}
    log(f"loop path: {rec['tracked']}/{n} tracked, {rec['keyframes']} keyframes, {rec['map_points']} live map points, "
        f"{rec['loops_closed']} loops closed {closer.closures} (insertion count, keyframe, loop keyframe), {rec['detect_suppressed']} detection rounds suppressed, "
        f"GBA runs {rec['gba_runs']} / merged {rec['gba_merged']} / aborted {rec['gba_aborted']}, "
        f"GBA solve ms {[round(x, 1) for x in runner.solve_ms]}, ATE {ate:.4f} m with loop closing over {n} frames "
        f"(rigid-aligned; bound {LOOP_ATE_BOUND:.4f}), {ate_anchored:.4f} m (first-frame anchored), "
        f"wall {wall:.2f} s = {n / wall:.2f} frames/s incl. initialization and the loop rounds, "
        f"host syncs {syncs} ({syncs / n:.1f}/frame), launches {launches}, {card}")
    if rec["tracked"] < 0.9 * n:
        raise AssertionError(f"loop path tracked {rec['tracked']}/{n} < 90%")
    if closer.n_loops_closed < 1:
        raise AssertionError("no loop closed on the orbit")
    if not ate <= LOOP_ATE_BOUND:
        raise AssertionError(f"loop path ATE {ate:.4f} m > {LOOP_ATE_BOUND:.4f} m")
    if launches["fast_score_nms"] != n:
        raise AssertionError(f"fast_score_nms: {launches['fast_score_nms']} launches for {n} frames, expected one each")
    if launches["masked_best_two"] <= rec["tracked"]:
        raise AssertionError(f"masked_best_two: {launches['masked_best_two']} launches for {rec['tracked']} tracked frames")
    if runner.running:
        raise AssertionError("a global-BA thread is still running after the sequence")
    rec["headline_fps"], rec["headline_spread"] = headline
    return rec, launches, poses, ok, headline


def ate_of(slam, gt_Tcw, align_scale=False, before=None):
    """The repository's ATE (`utils.trajectory.ate_rmse`, rigid unless
    `align_scale`) of a SlamSystem's trajectory, resolved with its final
    keyframe poses, against ground-truth Tcw keyed by timestamp; only the
    frames with timestamps < `before`, if given."""
    import numpy as np
    from orb_slam2v2_1_tpu_torch.utils.trajectory import ate_rmse

    est = slam.trajectory.absolute_poses(slam.map.kf_pose.cpu().numpy())
    if before is not None:
        est = [(t, T) for t, T in est if t < before - 1e-9]
    return ate_rmse(est, {t: np.linalg.inv(T) for t, T in gt_Tcw.items()}, align_scale=align_scale)


def online_record(slam, n, tracked, wall, launches, syncs, ate, card, **extra):
    st = slam.stats()
    return {"frames": n, "tracked": tracked, "keyframes": slam.n_kf_host,
            "map_points": int(slam.map.mp_valid.sum()), "loops_closed": slam.n_loops_closed,
            "relocalized": slam.n_relocalized, "resets": slam.n_resets, "ate_m": ate, "wall_s": wall,
            "fps": n / wall, "track_ms_p50": st["track_ms_p50"], "track_ms_p90": st["track_ms_p90"],
            "map_ms_p50": st["map_ms_p50"], "host_syncs": syncs, "host_syncs_per_frame": syncs / n,
            "launches": launches, "stats": st, "card": card, **extra}


def n_posed(outs):
    """How many `track_*` calls returned a pose."""
    return sum(o is not None for o in outs)


def drive(slam, frames, track):
    """Feed (a, b) pairs through `track` with counts reset just before;
    returns (poses or None, states, wall s, launches, host reads)."""
    import torch
    from orb_slam2v2_1_tpu_torch import kernels, sync

    kernels.reset_launch_counts()
    sync.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, states = [], []
    for j, (a, b) in enumerate(frames):
        outs.append(track(a, b, j * 0.1))
        states.append(slam.state)
    torch.cuda.synchronize()
    return outs, states, time.perf_counter() - t0, dict(kernels.LAUNCHES), sync.COUNT["syncs"]


def check_pnp_on_card(dev):
    """The PnP RANSAC's batched float64 eigen solve on the card against the
    CPU on exact correspondences with 20% outliers, each drawing its
    hypothesis sets from the same key: the same inlier set and count, poses
    within 1e-4."""
    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch.ops import pnp, prng

    rng = np.random.default_rng(4)
    n = 1000
    pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 6, n)], -1)
    uv = np.stack([550 * pc[:, 0] / pc[:, 2] + 320, 550 * pc[:, 1] / pc[:, 2] + 240], -1)
    uv[::5] = rng.uniform([0, 0], [640, 480], (n // 5, 2))
    args = [torch.from_numpy(a.astype(np.float32)) for a in (pc, uv, np.ones(n))] + [torch.ones(n, dtype=torch.bool)]
    K = torch.tensor([550.0, 550.0, 320.0, 240.0])
    ref = pnp.pnp_ransac(*args, K, key=prng.key(1))
    got = pnp.pnp_ransac(*(a.to(dev) for a in args), K.to(dev), key=prng.key(1))
    same = torch.equal(got.inliers.cpu(), ref.inliers)
    dT = float((got.Tcw.cpu() - ref.Tcw).abs().max())
    log(f"PnP RANSAC (256 x 12x12 float64 eigh, 1000 points): card {int(got.n_inliers)} inliers, CPU "
        f"{int(ref.n_inliers)}, same inlier set {same}, pose difference {dT:.2e}")
    if not (same and int(got.n_inliers) == int(ref.n_inliers) and dT <= 1e-4):
        raise AssertionError("PnP RANSAC on the card disagrees with the CPU")
    return {"inliers": int(got.n_inliers), "same_inlier_set": same, "max_pose_diff": dT}


def check_draws(kt, dev, card):
    """Phase 21: each draw of DRAWS on the card and on the CPU from the same
    key and mask: the 32-bit words and the sets equal; ms per draw (events
    around one call, median of 20), device time and launches per draw (the
    profiler's kernel rows)."""
    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch.ops import pnp, prng, sim3solver, twoview

    samplers = {"pnp": (pnp.sample_sets, pnp.N_HYP, pnp.SAMPLE),
                "sim3": (sim3solver.hypothesis_sets, sim3solver.N_HYP, 3),
                "two_view_h": (twoview.sample_sets, twoview.N_RANSAC, 8),
                "two_view_f": (twoview.sample_sets, twoview.N_RANSAC, 8)}
    rng = np.random.default_rng(21)
    rows = []
    for name, seed, sampler, n in DRAWS:
        draw, n_sets, k = samplers[sampler]
        key = prng.key(seed)
        if sampler.startswith("two_view"):
            key = prng.split(key)[sampler == "two_view_f"]
        valid = torch.from_numpy(rng.uniform(size=n) < 1 / 3)
        valid_card = valid.to(dev)
        same_bits = torch.equal(prng.bits32(key, (n_sets, n), dev).cpu(), prng.bits32(key, (n_sets, n)))
        cpu_sets, card_sets = draw(valid, key), draw(valid_card, key)
        same_sets = card_sets.device == valid_card.device and torch.equal(card_sets.cpu(), cpu_sets)
        ms = kt.wrapper_us(lambda: draw(valid_card, key)) / 1e3
        busy, launches = kt.busy_us(lambda: draw(valid_card, key))
        rows.append({"name": name, "seed": seed, "shape": [n_sets, n], "k": k, "same_bits": same_bits,
                     "same_sets": same_sets, "ms": ms, "device_ms": busy / 1e3, "launches": launches})
        log(f"draw {name} (key {seed}, {n_sets} x {n}, top {k}): card = CPU bits {same_bits}, sets {same_sets}; "
            f"{ms:.4f} ms per draw, device {busy / 1e3:.4f} ms, {launches:.0f} launches, {card}")
        if not (same_bits and same_sets):
            raise AssertionError(f"draw {name}: the card's draw differs from the CPU's")
    return rows


def run_online_rgbd(imgs, deps, gt, cfg, card):
    """Phase 6: the orbit with a blackout and a far replay through
    SlamSystem.track_rgbd on the card."""
    import torch
    from orb_slam2v2_1_tpu_torch.models.system import Sensor, SlamSystem, TrackState

    slam = SlamSystem(config=cfg, sensor=Sensor.RGBD)  # no device given: the card
    black = torch.zeros_like(imgs[0])
    frames = [(black, black) if k is None else (imgs[k], deps[k]) for k in ONLINE_SEQUENCE]
    n_kf_before = []

    def track(a, b, ts):
        if round(ts * 10) == BLACKOUT.start:
            n_kf_before.append(slam.n_kf_host)
        return slam.track_rgbd(a, b, ts)

    outs, states, wall, launches, syncs = drive(slam, frames, track)
    import numpy as np

    g0 = np.linalg.inv(gt[0])
    ate = ate_of(slam, {j * 0.1: gt[k] @ g0 for j, k in enumerate(ONLINE_SEQUENCE) if k is not None})
    seen = [o for o, k in zip(outs, ONLINE_SEQUENCE) if k is not None]
    replay = next((j - REPLAY for j in range(REPLAY, REPLAY + 2) if outs[j] is not None), None)
    far = next((j - FAR.start for j in range(FAR.start, FAR.stop) if outs[j] is not None), None)
    rec = online_record(slam, len(outs), n_posed(outs), wall, launches, syncs, ate, card, ate_bound_m=ONLINE_ATE_BOUND,
                        keyframes_before_blackout=n_kf_before[0], lost_on_black=[s.name for s in states[BLACKOUT]],
                        replay_tracked_after=replay, far_relocalized_after=far,
                        tracked_share=sum(o is not None for o in seen) / len(seen))
    log(f"online RGB-D path: {rec['tracked']}/{rec['frames']} frames returned a pose, {n_kf_before[0]} keyframes "
        f"before the blackout, black frames {rec['lost_on_black']}, replay tracked after {replay} frames, "
        f"frames 30-32 relocalized after {far}, {slam.n_relocalized} relocalizations, {slam.n_resets} resets, "
        f"{slam.n_kf_host} keyframes, {slam.n_loops_closed} loops, ATE {ate:.4f} m (bound {ONLINE_ATE_BOUND:.4f}), "
        f"track ms p50 {rec['track_ms_p50']:.1f} p90 {rec['track_ms_p90']:.1f}, map ms p50 {rec['map_ms_p50']}, "
        f"{rec['fps']:.2f} frames/s, host syncs {syncs / len(outs):.1f}/frame, launches {launches}, {card}")
    if not n_kf_before[0] > 5:
        raise AssertionError(f"only {n_kf_before[0]} keyframes before the blackout")
    if any(outs[j] is not None or states[j] != TrackState.LOST for j in range(BLACKOUT.start, BLACKOUT.stop)):
        raise AssertionError(f"a black frame was not lost: {rec['lost_on_black']}")
    if replay is None or slam.n_resets != 0:
        raise AssertionError(f"no pose on the first two replayed frames (resets {slam.n_resets})")
    if far is None or slam.n_relocalized < 1:
        raise AssertionError("frames 30-32 were not relocalized")
    if rec["tracked_share"] < 0.9:
        raise AssertionError(f"online path tracked {rec['tracked_share']:.3f} of the frames < 90%")
    if not ate <= ONLINE_ATE_BOUND:
        raise AssertionError(f"online path ATE {ate:.4f} m > {ONLINE_ATE_BOUND:.4f} m")
    return rec, launches


def run_leg(cfg, sensor, frames, gt, align_scale=False):
    """Track (a, b) frame pairs (image and depth, left and right, or image
    and None) at timestamps j * 0.1 through `evaluate.run_sequence`, in a
    sync `SlamSystem` of `sensor` on the card, with the counts reset just
    before; ATE against the ground-truth Tcw `gt` (scale-aligned if
    `align_scale`). Returns (the system, evaluate's result, wall s,
    launches, host reads)."""
    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch import evaluate, kernels, sync
    from orb_slam2v2_1_tpu_torch.models.system import SlamSystem

    slam = SlamSystem(config=cfg, sensor=sensor)  # no device given: the card
    ts = [j * 0.1 for j in range(len(frames))]
    kernels.reset_launch_counts()
    sync.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluate.run_sequence(cfg, sensor, frames, ts, {t: np.linalg.inv(T) for t, T in zip(ts, gt)},
                                align_scale=align_scale, slam=slam)
    torch.cuda.synchronize()
    return slam, res, time.perf_counter() - t0, dict(kernels.LAUNCHES), sync.COUNT["syncs"]


def leg_record(slam, res, wall, launches, syncs, card, **extra):
    """`online_record` of a leg run by `run_leg`, with evaluate's result;
    its tracked count and ATE are evaluate's."""
    return online_record(slam, res["frames"], res["tracked"], wall, launches, syncs, res["ate_rmse_m"], card,
                         evaluate=res, **extra)


def run_stereo(name, cfg, n, step, ate_bound, min_tracked, card, cpu_check=False):
    """Phases 7 and 8: a dolly through SlamSystem.track_stereo on the card."""
    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch.models import frontend
    from orb_slam2v2_1_tpu_torch.models.system import Sensor
    from orb_slam2v2_1_tpu_torch.ops import orb
    from orb_slam2v2_1_tpu_torch.utils import synthetic

    left, right, gt = synthetic.stereo_dolly_frames(cfg, range(n), np.random.default_rng(3), dx=step[0], dz=step[1])
    slam, res, wall, launches, syncs = run_leg(cfg, Sensor.STEREO, list(zip(left, right)), gt)
    ate = res["ate_rmse_m"]
    extra = {"ate_bound_m": ate_bound}
    if cpu_check:
        # The first pair's stereo frame on the CPU (plain versions) and the card.
        ocfg = orb.OrbConfig(n_features=cfg.n_features, n_levels=cfg.n_levels, scale=cfg.scale_factor,
                             fast_threshold=cfg.fast_threshold, fast_min_threshold=cfg.fast_min_threshold)
        K, dist, bf = torch.tensor(cfg.K), torch.tensor(cfg.dist), float(np.float32(cfg.bf))
        fc = frontend.build_frame_stereo(left[0].cpu(), right[0].cpu(), K, dist, bf, 0, ocfg)
        fg = frontend.build_frame_stereo(left[0], right[0], K.to(left.device), dist.to(left.device), bf, 0, ocfg)
        same = bool(torch.equal(fc.kp_valid, fg.kp_valid.cpu()) and torch.equal(fc.level, fg.level.cpu()))
        both = (fc.ur >= 0) & (fg.ur.cpu() >= 0)
        d_ur = float((fc.ur - fg.ur.cpu())[both].abs().max())
        agree = float(((fc.ur >= 0) == (fg.ur.cpu() >= 0)).float().mean())
        extra.update(cpu_same_keypoints=same, cpu_stereo_agree=agree, cpu_max_ur_diff=d_ur)
        log(f"{name}: first pair on the CPU: same keypoints {same}, stereo match agrees on {agree:.4f} of slots, "
            f"max ur difference {d_ur:.2e} px")
        if not (same and agree >= 0.99 and d_ur <= 1e-3):
            raise AssertionError(f"{name}: the card's stereo frame disagrees with the CPU's")
    rec = leg_record(slam, res, wall, launches, syncs, card, **extra)
    tracked_at = {round(e.timestamp * 10) for e in slam.trajectory.entries if not e.lost}
    rec["untracked_frames"] = [j for j in range(n) if j not in tracked_at]
    log(f"{name}: {rec['tracked']}/{n} tracked (lost: {rec['untracked_frames']}), {slam.n_kf_host} keyframes, "
        f"{rec['map_points']} points, "
        f"ATE {ate:.5f} m (bound {ate_bound:.4f}), track ms p50 {rec['track_ms_p50']:.1f} p90 "
        f"{rec['track_ms_p90']:.1f}, {rec['fps']:.2f} frames/s, host syncs {syncs / n:.1f}/frame, "
        f"launches {launches}, {card}")
    if rec["tracked"] < min_tracked:
        raise AssertionError(f"{name}: tracked {rec['tracked']}/{n} < {min_tracked}")
    if not ate <= ate_bound:
        raise AssertionError(f"{name}: ATE {ate:.5f} m > {ate_bound:.5f} m")
    if launches["fast_score_nms"] != 2 * n:
        raise AssertionError(f"{name}: fast_score_nms {launches['fast_score_nms']} launches for {n} stereo frames")
    return rec, launches


def run_desk(name, cfg, sensor, poses, ate_bound, card):
    """Phases 9 and 10: an evaluate.py desk leg through SlamSystem on the
    card, counted by evaluate's `run_sequence`."""
    from orb_slam2v2_1_tpu_torch.models.system import Sensor
    from orb_slam2v2_1_tpu_torch.utils import synthetic

    imgs, deps, gt = synthetic.desk_frames(cfg, poses)  # no device given: the card
    frames = list(zip(imgs, [None] * len(imgs) if sensor == Sensor.MONOCULAR else deps))
    return run_frames(name, cfg, sensor, frames, gt, ate_bound, card)


def run_frames(name, cfg, sensor, frames, gt, ate_bound, card):
    """Track (a, b) frame pairs through `run_leg`; ATE against the
    ground-truth Tcw `gt` (scale-aligned for mono) within `ate_bound`,
    fast_score_nms launched once per image."""
    from orb_slam2v2_1_tpu_torch.models.system import Sensor

    mono = sensor == Sensor.MONOCULAR
    slam, res, wall, launches, syncs = run_leg(cfg, sensor, frames, gt, align_scale=mono)
    n, tracked, ate = res["frames"], res["tracked"], res["ate_rmse_m"]
    entries = slam.trajectory.entries
    first = next((round(e.timestamp * 10) for e in entries if not e.lost), None)
    post_init = res["tracked_frac_post_init"] if first is not None else 0.0
    rec = leg_record(slam, res, wall, launches, syncs, card, ate_bound_m=ate_bound, tracked_share=tracked / n,
                     tracked_share_post_init=post_init, first_pose_frame=first, scale_aligned=mono)
    log(f"{name}: {tracked}/{n} tracked (post-init share {post_init:.3f}, first pose at frame "
        f"{rec['first_pose_frame']}), {slam.n_kf_host} keyframes, {slam.n_relocalized} relocalizations, "
        f"{slam.n_resets} resets, {rec['map_points']} points, ATE {ate:.5f} m{' scale-aligned' if mono else ''} "
        f"(bound {ate_bound:.5f}), track ms p50 {rec['track_ms_p50']:.1f} p90 {rec['track_ms_p90']:.1f}, "
        f"{rec['fps']:.2f} frames/s, host syncs {syncs / n:.1f}/frame, launches {launches}, {card}")
    if not ate <= ate_bound:
        raise AssertionError(f"{name}: ATE {ate:.5f} m > {ate_bound:.5f} m")
    per_frame = 2 if sensor == Sensor.STEREO else 1
    if launches["fast_score_nms"] != per_frame * n:
        raise AssertionError(f"{name}: fast_score_nms {launches['fast_score_nms']} launches for {n} frames")
    for kernel, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {kernel} was not launched by the {name} path")
    return rec, launches


def run_adversarial(name, cfg, sensor, scene, poses, rng, clean_ate, card):
    """Phases 14-16: an evaluate.py adversarial leg, its frames degraded as
    evaluate.py degrades them (`synthetic.adversarial_frames`, one generator
    through the exposure schedule and every frame's noise), held to
    evaluate.py's gate (evaluate.py:288-304): ATE <= max(3 x the clean twin's
    ATE in this run, 0.05 m) and a tracked share after the first pose >=
    0.85; and tracked at least the reference's count on the same frames
    less 2 (ADV_REF)."""
    from orb_slam2v2_1_tpu_torch.models.system import Sensor
    from orb_slam2v2_1_tpu_torch.utils import synthetic

    mode = {Sensor.RGBD: "rgbd", Sensor.MONOCULAR: "mono", Sensor.STEREO: "stereo"}[sensor]
    imgs, second = synthetic.adversarial_frames(cfg, scene, poses, rng, mode)
    frames = list(zip(imgs, [None] * len(imgs) if second is None else second))
    bound = max(3.0 * clean_ate, ADV_ATE_FLOOR)
    rec, launches = run_frames(name, cfg, sensor, frames, poses, bound, card)
    ref_tracked, ref_ate = ADV_REF[name]
    rec.update(clean_twin_ate_m=clean_ate, reference_tracked=ref_tracked, reference_ate_m=ref_ate)
    if rec["tracked_share_post_init"] < ADV_MIN_POST_INIT:
        raise AssertionError(f"{name}: tracked share after the first pose {rec['tracked_share_post_init']:.3f} < "
                             f"{ADV_MIN_POST_INIT}")
    if rec["tracked"] < ref_tracked - 2:
        raise AssertionError(f"{name}: tracked {rec['tracked']} < the reference's {ref_tracked} less 2")
    return rec, launches


# Runs the module named by its first argument as `python -m` would, with the
# remaining arguments, then prints the kernels' launch counts of the process.
MODULE_WRAPPER = """
import json, runpy, sys
from orb_slam2v2_1_tpu_torch import kernels
module = sys.argv.pop(1)
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
finally:
    print("kernel launches: " + json.dumps(kernels.LAUNCHES), flush=True)
"""


def printed_launches(stdout: str) -> dict:
    """The launch counts a process run through MODULE_WRAPPER printed last."""
    return json.loads(stdout.split("kernel launches: ")[-1].splitlines()[0])


def settings_text(cfg) -> str:
    """`cfg` as a settings file in the reference's YAML style
    (`utils/config.py load_settings`), no distortion."""
    rows = [("Camera.fx", cfg.fx), ("Camera.fy", cfg.fy), ("Camera.cx", cfg.cx), ("Camera.cy", cfg.cy),
            ("Camera.k1", 0.0), ("Camera.k2", 0.0), ("Camera.p1", 0.0), ("Camera.p2", 0.0),
            ("Camera.width", cfg.width), ("Camera.height", cfg.height), ("Camera.fps", cfg.fps),
            ("Camera.bf", cfg.bf), ("ThDepth", cfg.th_depth), ("DepthMapFactor", cfg.depth_map_factor),
            ("ORBextractor.nFeatures", cfg.n_features), ("ORBextractor.scaleFactor", cfg.scale_factor),
            ("ORBextractor.nLevels", cfg.n_levels), ("ORBextractor.iniThFAST", cfg.fast_threshold),
            ("ORBextractor.minThFAST", cfg.fast_min_threshold)]
    return "%YAML:1.0\n" + "".join(f"{k}: {v}\n" for k, v in rows)


def write_cli_dataset(cfg, data_dir, device=None):
    """Phase 17's TUM-layout directory: CLI_FRAMES frames of evaluate.py's
    desk sweep, rendered on `device` (None: the card), with its settings file
    `desk.yaml`. Returns the settings file's path."""
    import shutil

    from orb_slam2v2_1_tpu_torch.utils import datasets, synthetic

    shutil.rmtree(data_dir, ignore_errors=True)
    imgs, deps, gt = synthetic.desk_frames(cfg, synthetic.desk_trajectory(CLI_FRAMES), device=device)
    datasets.write_tum_rgbd(os.path.join(data_dir, "seq"), imgs.cpu().numpy(), deps.cpu().numpy(), gt)
    yaml = os.path.join(data_dir, "desk.yaml")
    with open(yaml, "w") as f:
        f.write(settings_text(cfg))
    return yaml


def run_cli(cfg, card):
    """Phase 17: `python -m orb_slam2v2_1_tpu_torch.run_slam` on a written
    TUM directory, as a subprocess on the card in its default async mode;
    then the rectifier and the back-projection on the card against the CPU."""
    import re
    import shutil
    import subprocess

    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch.models.system import Sensor, SlamSystem, TrackState
    from orb_slam2v2_1_tpu_torch.ops import rectify
    from orb_slam2v2_1_tpu_torch.utils import config, datasets, pointcloud

    base = os.path.join(ROOT, "build", "chip_smoke")
    data_dir, out = os.path.join(base, "tum_desk"), os.path.join(base, "cli")
    t0 = time.perf_counter()
    yaml = write_cli_dataset(cfg, data_dir)
    write_s = time.perf_counter() - t0
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    files = {k: os.path.join(out, v) for k, v in (("traj", "traj.txt"), ("map", "map.npz"), ("ply", "map.ply"),
                                                   ("viz", "viz"))}
    cmd = [sys.executable, "-c", MODULE_WRAPPER, "orb_slam2v2_1_tpu_torch.run_slam", "--dataset",
           os.path.join(data_dir, "seq"), "--settings", yaml,
           "--out", files["traj"], "--save-map", files["map"], "--ply", files["ply"], "--viz-dir", files["viz"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "stdout.txt"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"run_slam CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    ate = float(re.search(r"ATE RMSE: ([0-9.]+) m", proc.stdout).group(1))
    fps = float(re.search(r"frames in [0-9.]+s \(([0-9.]+) fps\)", proc.stdout).group(1))
    p50, p90 = (float(x) for x in re.search(r"final stats: \S+ track p50/p90=([0-9.]+)/([0-9.]+)ms",
                                             proc.stdout).groups())
    with open(files["traj"]) as f:
        tracked = sum(1 for ln in f if ln.strip())
    launches = printed_launches(proc.stdout)
    slam = SlamSystem(config=config.load_settings(yaml), sensor=Sensor.RGBD)  # no device given: the card
    slam.load_map(files["map"])
    mp_pos, mp_valid = (t.cpu().numpy() for t in (slam.map.mp_pos, slam.map.mp_valid))
    with open(files["ply"]) as f:
        lines = f.read().splitlines()
    ply = np.array([[float(v) for v in ln.split()] for ln in lines[lines.index("end_header") + 1:]])
    pngs = sorted(os.listdir(files["viz"]))
    bound = 2 * CLI_REF_ATE
    rec = {"path": "cli_run_slam", "frames": CLI_FRAMES, "tracked": tracked, "track_ms_p50": p50,
           "track_ms_p90": p90, "ate_m": ate, "ate_bound_m": bound,
           "reference_ate_m": CLI_REF_ATE, "fps_printed": fps, "wall_s": wall, "dataset_write_s": write_s,
           "launches": launches, "map_keyframes": slam.n_kf_host, "map_points": int(mp_valid.sum()),
           "ply_points": len(ply), "pngs": len(pngs), "card": card}
    # The rectifier at EuRoC's factory calibration and the back-projection,
    # on the card against the CPU (the same host-built maps).
    rng = np.random.default_rng(5)
    W, H = datasets.EUROC_CALIB["size"]
    left, right = ((rng.random((H, W)) * 255).astype(np.float32) for _ in range(2))
    calib = [datasets.EUROC_CALIB[k] for k in ("K1", "D1", "K2", "D2", "R", "T", "size")]
    on_card = rectify.StereoRectifier(*calib)  # no device given: the card
    on_cpu = rectify.StereoRectifier(*calib, device="cpu")
    rect_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(on_card(left, right), on_cpu(left, right)))
    depth = datasets.read_depth_tum(os.path.join(data_dir, "seq", "depth", "00000.png"))
    depth[::7, ::5] = 0.0  # holes
    Tcw = torch.eye(4)
    Tcw[:3, 3] = torch.tensor([0.1, -0.2, 0.3])
    K = torch.tensor(cfg.K, dtype=torch.float32)
    dev = on_card.device
    bp_card = pointcloud.backproject(torch.from_numpy(depth).to(dev), Tcw.to(dev), K.to(dev)).cpu().numpy()
    bp_cpu = pointcloud.backproject(torch.from_numpy(depth), Tcw, K).numpy()
    same_nan = bool(np.array_equal(np.isnan(bp_card), np.isnan(bp_cpu)))
    bp_err = float(np.nanmax(np.abs(bp_card - bp_cpu)))
    rec.update(rectifier_max_err=rect_err, backproject_max_err_m=bp_err, backproject_same_nan=same_nan)
    log(f"cli run_slam: exit 0, {tracked}/{CLI_FRAMES} tracked, {slam.n_kf_host} keyframes, ATE {ate:.5f} m (bound "
        f"{bound:.5f}, the reference {CLI_REF_ATE}), track ms p50 {p50:.1f} p90 {p90:.1f}, {fps:.2f} frames/s "
        f"printed, {wall:.1f} s with start-up, map {int(mp_valid.sum())} points, PLY "
        f"{len(ply)} points, {len(pngs)} PNGs, launches {launches}; rectifier card vs CPU {rect_err:.2e} gray "
        f"levels, backproject {bp_err:.2e} m (same NaN rows {same_nan}), {card}")
    if not ate <= bound:
        raise AssertionError(f"cli run_slam: ATE {ate:.5f} m > {bound:.5f} m")
    if slam.state != TrackState.LOST or slam.n_kf_host < 2:
        raise AssertionError(f"cli run_slam: the saved map loads as {slam.state}, {slam.n_kf_host} keyframes")
    if len(ply) != int(mp_valid.sum()) or not np.allclose(ply, mp_pos[mp_valid], atol=1e-4):
        raise AssertionError(f"cli run_slam: the PLY's {len(ply)} points are not the map's {int(mp_valid.sum())}")
    if not any(p.startswith("frame_") for p in pngs) or not any(p.startswith("map_") for p in pngs):
        raise AssertionError(f"cli run_slam: viz PNGs missing: {pngs}")
    if launches["fast_score_nms"] != CLI_FRAMES or launches["masked_best_two"] <= 0:
        raise AssertionError(f"cli run_slam: launches {launches} for {CLI_FRAMES} frames")
    if not (rect_err <= 1e-3 and bp_err <= 1e-5 and same_nan):
        raise AssertionError("cli: the rectifier or the back-projection on the card disagrees with the CPU")
    return rec, launches


def _wait_for(cond, what, timeout_s=60.0):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout_s:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _pose_err(T, T_gt):
    """(center distance m, rotation angle deg) between two Tcw."""
    import numpy as np

    T, T_gt = np.asarray(T, np.float64), np.asarray(T_gt, np.float64)
    c, c_gt = -T[:3, :3].T @ T[:3, 3], -T_gt[:3, :3].T @ T_gt[:3, 3]
    R = T[:3, :3] @ T_gt[:3, :3].T
    return float(np.linalg.norm(c - c_gt)), float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))


def two_session_frames(cfg, device=None):
    """Phase 18's frames: the desk sweep's frames 0 to SESSION_2's end,
    rendered in one world (the first camera's, as evaluate.py's desk legs
    are), on `device` (None: the card). Returns images, depths and the
    ground-truth Tcw in that world; a session's truth in its own world is
    gt[f] @ inv(gt[its first frame])."""
    from orb_slam2v2_1_tpu_torch.utils import synthetic

    return synthetic.desk_frames(cfg, synthetic.desk_trajectory(DESK_FRAMES)[:SESSION_2[1]], device=device)


def run_two_sessions(cfg, card):
    """Phase 18: two sessions on one map server on loopback, on the card.
    Session 1 streams desk frames SESSION_1, session 2 frames SESSION_2 (in
    its own world, its first frame's); session 2 fetches its map merged with
    session 1's, starts LOST and relocalizes on frames only session 1 saw."""
    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch import kernels, sync
    from orb_slam2v2_1_tpu_torch.models.system import Sensor, SlamSystem, TrackState
    from orb_slam2v2_1_tpu_torch.parallel.stream import MapServerNode, OperatorClient
    from orb_slam2v2_1_tpu_torch.utils import serialization

    all_imgs, all_deps, all_gt = two_session_frames(cfg)
    node = MapServerNode(port=0, max_kf=cfg.max_keyframes, max_mp=cfg.max_map_points, n_kp=cfg.n_features)
    node.set_intrinsics(cfg.K)
    clients = []
    try:
        recs = []
        for cid, (a, b) in ((1, SESSION_1), (2, SESSION_2)):
            imgs, deps = all_imgs[a:b], all_deps[a:b]
            gt = [T @ np.linalg.inv(all_gt[a]) for T in all_gt[a:b]]
            slam = SlamSystem(config=cfg, sensor=Sensor.RGBD)
            clients.append(slam)
            slam.connect_server("127.0.0.1", node.port, cid)
            outs, _, wall, launches, syncs = drive(slam, list(zip(imgs, deps)), slam.track_rgbd)
            ate = ate_of(slam, {j * 0.1: T for j, T in enumerate(gt)})
            recs.append(online_record(slam, len(outs), n_posed(outs), wall, launches, syncs, ate, card, session=cid,
                                      frames_of_sweep=[a, b - 1]))
        s1, s2 = clients
        for cid, slam in ((1, s1), (2, s2)):
            _wait_for(lambda: cid in node.server.clients and node.server.clients[cid].n_deltas >= slam._stream.n_queued,
                      f"the server to apply session {cid}'s deltas")
        op = OperatorClient("127.0.0.1", node.port)
        try:
            listing = op.list_clients()
        finally:
            op.close()
        n1, n2 = (int(node.server.client_map(c).n_kf) for c in (1, 2))
        mp1, mp2 = (int(node.server.client_map(c).n_mp) for c in (1, 2))
        os.makedirs(os.path.join(ROOT, "build", "chip_smoke"), exist_ok=True)
        for c in (1, 2):
            serialization.save_map(node.server.client_map(c), os.path.join(ROOT, "build", "chip_smoke",
                                                                           f"session{c}.npz"))

        # --- the merge, on the server's connection thread ---
        kernels.reset_launch_counts()
        sync.reset()
        t0 = time.perf_counter()
        s2.fetch_server_map(merge_with=1)
        fetch_ms = (time.perf_counter() - t0) * 1e3
        merge = dict(node.last_merge or {})
        merge_launches = {k: dict(v) for k, v in kernels.LAUNCHES_BY_ROLE.items()}
        server_reads = sync.BY_ROLE.get("server", 0)
        merged_kf = int(s2.map.n_kf)
        # Session 1's keyframes follow session 2's in the merged map (session 2
        # is the merge's fixed side); their ground truth in session 2's world.
        kf_valid, kf_pose, kf_frame = (t.cpu().numpy() for t in (s2.map.kf_valid, s2.map.kf_pose, s2.map.kf_frame_id))
        g0 = np.linalg.inv(all_gt[SESSION_2[0]])
        errs = [_pose_err(kf_pose[n2 + k], all_gt[SESSION_1[0] + int(kf_frame[n2 + k])] @ g0)[0]
                for k in range(n1) if kf_valid[n2 + k]]
        center_rms = float(np.sqrt(np.mean(np.square(errs)))) if errs else float("inf")
        state_after_fetch = s2.state

        # --- session 2 on frames only session 1 saw ---
        relocs, relocalize, reloc_outs = [], s2._relocalize, []

        def logged_relocalize(frame, frame_id=None):
            out = relocalize(frame, frame_id)
            relocs.append((len(reloc_outs), out[3]))
            return out

        s2._relocalize = logged_relocalize
        for j, f in enumerate(range(*REVISIT)):
            reloc_outs.append(s2.track_rgbd(all_imgs[f], all_deps[f], (SESSION_2[1] - SESSION_2[0] + j) * 0.1))
        first = next((j for j, o in enumerate(reloc_outs) if o is not None), None)
        reloc_kf = next((kf for _, kf in relocs if kf is not None), None)
        # The last revisit frame's map points from session 1's part of the merged map.
        (frame_mp,) = sync.host_numpy(s2.last_frame.mp)
        s1_points = int(((frame_mp >= mp2) & (frame_mp < mp2 + mp1)).sum())
        state_after_revisit = s2.state
        reloc_err = (_pose_err(reloc_outs[first], all_gt[REVISIT[0] + first] @ g0) if first is not None
                     else (float("inf"),) * 2)
        worker_errors = [c._stream.exception for c in clients]
        bytes_sent = [c._stream.bytes_sent for c in clients]
        max_delta = max(c._stream.max_delta for c in clients)
    finally:
        for slam in clients:
            slam.shutdown()
        node.stop()
    bound = 2 * SERVER_REF_CENTER_RMS
    rec = {"path": "two_sessions", "sessions": recs, "listed_clients": sorted(listing.get("clients", {})),
           "session_keyframes": [n1, n2], "merged_keyframes": merged_kf, "merge": merge, "fetch_ms": fetch_ms,
           "merge_launches_by_thread": merge_launches, "server_reads": server_reads,
           "session1_center_rms_m": center_rms, "center_rms_bound_m": bound,
           "reference_center_rms_m": SERVER_REF_CENTER_RMS, "revisit_frames": list(range(*REVISIT)),
           "revisit_poses": [o is not None for o in reloc_outs], "relocalized_on": reloc_kf,
           "revisit_session1_points": s1_points, "state_after_revisit": state_after_revisit.name,
           "reloc_err_m_deg": reloc_err, "bytes_streamed": bytes_sent, "largest_delta": max_delta,
           "worker_errors": [repr(e) for e in worker_errors if e is not None], "card": card}
    for r in recs:
        log(f"two sessions, session {r['session']} (sweep frames {r['frames_of_sweep']}): {r['tracked']}/{r['frames']} "
            f"tracked, {r['keyframes']} keyframes, ATE {r['ate_m']:.5f} m, track ms p50 {r['track_ms_p50']:.1f} p90 "
            f"{r['track_ms_p90']:.1f}, {r['fps']:.2f} frames/s, launches {r['launches']}")
    log(f"two sessions: listed {rec['listed_clients']}, merge of {n1}+{n2} keyframes -> {merged_kf}: {merge}, fetch "
        f"{fetch_ms:.1f} ms, masked_best_two by thread during the merge {merge_launches['masked_best_two']}, session 1's "
        f"keyframe centers {center_rms:.4f} m RMS from the truth in session 2's world (bound "
        f"{bound:.4f}), after the fetch "
        f"{state_after_fetch.name}; frames {list(range(*REVISIT))}: poses {rec['revisit_poses']} (relocalized on "
        f"keyframe {reloc_kf}; session 1's are {n2}-{n2 + n1 - 1}), {state_after_revisit.name} with {s1_points} of "
        f"session 1's points, error {reloc_err[0]:.4f} m {reloc_err[1]:.3f} deg; "
        f"bytes streamed {bytes_sent}, largest delta {max_delta}, map {merge.get('bytes')} bytes, {card}")
    if set(rec["listed_clients"]) != {"1", "2"}:
        raise AssertionError(f"two sessions: the operator lists {rec['listed_clients']}")
    if not (merge.get("accepted") and merged_kf == n1 + n2 and merge.get("fused", 0) > 0):
        raise AssertionError(f"two sessions: the merge was not accepted: {merge}, {merged_kf} keyframes")
    if state_after_fetch != TrackState.LOST:
        raise AssertionError(f"two sessions: session 2 is {state_after_fetch} after the fetch")
    if merge_launches["masked_best_two"].get("server", 0) <= 0:
        raise AssertionError(f"two sessions: masked_best_two was not launched on the server's thread: {merge_launches}")
    if not center_rms <= bound:
        raise AssertionError(f"two sessions: session 1's keyframes {center_rms:.4f} m from the truth > {bound:.4f}")
    if state_after_revisit != TrackState.OK or s1_points < 20:
        raise AssertionError(f"two sessions: session 2 is {state_after_revisit} after the revisit with {s1_points} "
                             f"of session 1's points")
    if reloc_kf is not None and not n2 <= reloc_kf < n2 + n1:
        raise AssertionError(f"two sessions: relocalized on keyframe {reloc_kf}, not one of session 1's")
    if not (reloc_err[0] <= RELOC_POSE_BOUND[0] and reloc_err[1] <= RELOC_POSE_BOUND[1]):
        raise AssertionError(f"two sessions: the relocalized pose is {reloc_err} from the truth")
    if rec["worker_errors"]:
        raise AssertionError(f"two sessions: the stream's worker raised {rec['worker_errors']}")
    return rec, merge_launches


def drive_async(slam, run, frames):
    """Phases 11-12: one of the benchmark's legs (`run`: `bench.online_run`
    or `bench.kitti_run`) on a production system, with every count reset
    just before the first frame; then `stats()` and the timed `shutdown()`,
    as the leg's entry point ends. Returns the leg's keys, the per-call
    latencies (ms), the leg's wall (s, to the last call), the stats after
    the flush, the shutdown's seconds, and the counts read after the
    shutdown (the workers' last rounds included): launches, launches by
    thread role, host reads by thread role."""
    import torch
    from orb_slam2v2_1_tpu_torch import kernels, sync

    kernels.reset_launch_counts()
    sync.reset()
    torch.cuda.synchronize()
    try:
        out, lat, wall = run(slam, frames)
        st = slam.stats()
    finally:
        t1 = time.perf_counter()
        slam.shutdown()
        torch.cuda.synchronize()
        shut_s = time.perf_counter() - t1
    by_role = {k: dict(v) for k, v in kernels.LAUNCHES_BY_ROLE.items()}
    return out, lat, wall, st, shut_s, dict(kernels.LAUNCHES), by_role, dict(sync.BY_ROLE)


def async_record(slam, name, n, lat, wall, st, shut_s, launches, by_role, reads, ate, warm_s, card, **extra):
    import numpy as np

    entries = slam.trajectory.entries
    tracker_reads = reads.get("tracker", 0)
    worker_reads = sum(v for k, v in reads.items() if k != "tracker")
    return {"path": name, "frames": n, "entries": len(entries), "tracked": sum(not e.lost for e in entries),
            "keyframes": slam.n_kf_host, "map_points": int(slam.map.mp_valid.sum()),
            "loops_closed": slam.n_loops_closed, "relocalized": slam.n_relocalized, "resets": slam.n_resets,
            "ate_m": ate, "warmup_s": warm_s, "wall_s": wall, "fps": n / wall, "shutdown_s": shut_s,
            "track_ms_p50": float(np.percentile(lat, 50)), "track_ms_p90": float(np.percentile(lat, 90)),
            "track_ms_p99": float(np.percentile(lat, 99)), "track_ms_max": float(np.max(lat)),
            "map_ms_p50": st["map_ms_p50"], "loop_ms_p50": st["loop_ms_p50"], "in_flight_after_flush": st["in_flight"],
            "ba_skipped": st["ba_skipped"], "gba_runs": slam.loop_closer.gba_runner.n_runs,
            "gba_merged": slam.loop_closer.n_gba_merged, "host_reads_by_thread": reads,
            "tracker_reads_per_frame": tracker_reads / n, "worker_reads_per_frame": worker_reads / n,
            "launches": launches, "launches_by_thread": by_role, "stats": st, "card": card, **extra}


def check_async(rec, launches, by_role, slam, fast_per_frame):
    """The assertions both async legs share."""
    import numpy as np
    import torch

    name, n = rec["path"], rec["frames"]
    if rec["in_flight_after_flush"] != 0:
        raise AssertionError(f"{name}: {rec['in_flight_after_flush']} frames in flight after flush()")
    if slam.loop_closer.gba_runner.running:
        raise AssertionError(f"{name}: a global-BA thread is alive after shutdown()")
    if rec["entries"] != n:
        raise AssertionError(f"{name}: {rec['entries']} trajectory entries for {n} frames")
    kf_pose = slam.map.kf_pose.cpu().numpy()
    est = slam.trajectory.absolute_poses(kf_pose)
    if not (np.isfinite(kf_pose).all() and all(np.isfinite(T).all() for _, T in est)
            and bool(torch.isfinite(slam.map.mp_pos).all())):
        raise AssertionError(f"{name}: poses or points are not finite")
    if launches["fast_score_nms"] != fast_per_frame * n:
        raise AssertionError(f"{name}: fast_score_nms {launches['fast_score_nms']} launches for {n} frames")
    if by_role["masked_best_two"].get("mapping", 0) < 1:
        raise AssertionError(f"{name}: masked_best_two was never launched from the mapping worker")
    if by_role["fast_score_nms"].get("tracker", 0) != launches["fast_score_nms"]:
        raise AssertionError(f"{name}: fast_score_nms launched off the tracker thread: {by_role}")
    tracked = rec["tracked"] - 1 - rec["resets"]  # the first frame of a map initializes it
    if by_role["pose_lm"].get("tracker", 0) < 2 * tracked:
        raise AssertionError(f"{name}: the tracker launched pose_lm {by_role['pose_lm'].get('tracker', 0)} times "
                             f"for {tracked} tracked frames, expected at least two each")


def run_online_async(imgs, deps, gt, cfg, card, check=True):
    """Phase 11: the benchmark's online leg (`bench.online_leg`: its
    production system and its frame loop, bench.py:120-165) on the card;
    with check=False the record is returned without the phase's assertions.
    Returns the record, the launches, the system and the leg's keys."""
    import dataclasses

    import numpy as np
    from orb_slam2v2_1_tpu_torch import bench
    from orb_slam2v2_1_tpu_torch.models.system import Sensor

    slam, warm_s = bench.production_system(dataclasses.replace(cfg, fps=ASYNC_FPS), Sensor.RGBD)  # the card
    n = imgs.shape[0]
    # Which frames relocalized, on which keyframe (made from which frame):
    # a relocalization mid-orbit re-anchors the camera, possibly in the part
    # of the map a loop closure would have joined.
    relocs, relocalize = [], slam._relocalize

    def logged_relocalize(frame, frame_id=None):
        out = relocalize(frame, frame_id)
        f = slam.frame_id if frame_id is None else frame_id
        relocs.append((f, out[3], None if out[3] is None else int(slam.map.kf_frame_id[out[3]])))
        return out

    slam._relocalize = logged_relocalize
    out, lat, wall, st, shut_s, launches, by_role, reads = drive_async(slam, bench.online_run, list(zip(imgs, deps)))
    g0 = np.linalg.inv(gt[0])
    gt_t = {j / ASYNC_FPS: gt[j] @ g0 for j in range(n)}
    ate = ate_of(slam, gt_t)
    ate_prefix = ate_of(slam, gt_t, before=ASYNC_PREFIX / ASYNC_FPS)
    entries = slam.trajectory.entries
    past = [not e.lost for e in entries if round(e.timestamp * ASYNC_FPS) > REF_CRASH_FRAME]
    rec = async_record(slam, "online_async", n, lat, wall, st, shut_s, launches, by_role, reads, ate, warm_s, card,
                       **{f"ate_first_{ASYNC_PREFIX}_m": ate_prefix}, ate_first_frames_bound_m=ONLINE_ASYNC_ATE_BOUND,
                       reference_ate_first_frames_m=ONLINE_ASYNC_REF_PREFIX_ATE, reference_sync_ate_m=ONLINE_SYNC_REF_ATE,
                       ate_bound_m=ONLINE_ASYNC_FULL_ATE_BOUND,
                       lost_frames=[round(e.timestamp * ASYNC_FPS) for e in entries if e.lost],
                       decided_past_253=len(past), tracked_past_253=sum(past), relocalizations_at=relocs,
                       closures=slam.loop_closer.closures, losses=slam.losses, bench_keys=out)
    log(f"online async (bench.py's online leg): {rec['tracked']}/{n} tracked (lost: {rec['lost_frames']}), "
        f"{rec['tracked_past_253']}/{rec['decided_past_253']} past frame {REF_CRASH_FRAME}, {slam.n_kf_host} keyframes, "
        f"{slam.n_loops_closed} loops {slam.loop_closer.closures}, {slam.n_relocalized} relocalizations "
        f"(frame, keyframe, its frame: {relocs}), losses {slam.losses}, {slam.n_resets} resets, "
        f"ATE {ate:.4f} m (bound {ONLINE_ASYNC_FULL_ATE_BOUND:.4f}, twice the reference's sync mode), over frames 0-{ASYNC_PREFIX - 1} "
        f"{ate_prefix:.4f} m (bound {ONLINE_ASYNC_ATE_BOUND:.4f}), track ms p50 {rec['track_ms_p50']:.1f} "
        f"p90 {rec['track_ms_p90']:.1f} p99 {rec['track_ms_p99']:.1f} max {rec['track_ms_max']:.1f}, "
        f"map ms p50 {rec['map_ms_p50']}, loop ms p50 {rec['loop_ms_p50']}, BA skipped {rec['ba_skipped']}, "
        f"GBA runs {rec['gba_runs']} merged {rec['gba_merged']}, {rec['fps']:.2f} frames/s, "
        f"reads/frame tracker {rec['tracker_reads_per_frame']:.1f} workers {rec['worker_reads_per_frame']:.1f}, "
        f"launches {launches} by thread {by_role}, warmup {warm_s:.1f} s, shutdown {shut_s:.1f} s, {card}")
    if not check:
        return rec, launches, slam, out
    check_async(rec, launches, by_role, slam, 1)
    if rec["tracked"] < 0.9 * n:
        raise AssertionError(f"online async: tracked {rec['tracked']}/{n} < 90%")
    if rec["decided_past_253"] != n - 1 - REF_CRASH_FRAME or rec["tracked_past_253"] < 0.9 * rec["decided_past_253"]:
        raise AssertionError(f"online async: past frame {REF_CRASH_FRAME}, {rec['tracked_past_253']} of "
                             f"{rec['decided_past_253']} frames tracked")
    if slam.n_loops_closed < 1:
        raise AssertionError("online async: no loop closed on the orbit")
    if not ate_prefix <= ONLINE_ASYNC_ATE_BOUND:
        raise AssertionError(f"online async: ATE over frames 0-{ASYNC_PREFIX - 1} {ate_prefix:.4f} m > "
                             f"{ONLINE_ASYNC_ATE_BOUND:.4f} m")
    if not ate <= ONLINE_ASYNC_FULL_ATE_BOUND:
        raise AssertionError(f"online async: ATE over all {n} frames {ate:.4f} m > {ONLINE_ASYNC_FULL_ATE_BOUND:.4f} m")
    return rec, launches, slam, out


def run_kitti_async(card):
    """Phase 12: the benchmark's KITTI leg (`bench.kitti_leg`: its frames,
    production system and frame loop, bench.py:167-225) on the card.
    Returns the record, the launches and the leg's keys."""
    from orb_slam2v2_1_tpu_torch import bench
    from orb_slam2v2_1_tpu_torch.models.system import Sensor

    kcfg, left, right, gt = bench.kitti_frames()  # the card
    slam, warm_s = bench.production_system(kcfg, Sensor.STEREO, left.device, gba_buckets=(16, 32))
    out, lat, wall, st, shut_s, launches, by_role, reads = drive_async(slam, bench.kitti_run, list(zip(left, right)))
    ate = ate_of(slam, {j * 0.1: T for j, T in enumerate(gt)})
    rec = async_record(slam, "kitti_async", KITTI_FRAMES, lat, wall, st, shut_s, launches, by_role, reads, ate, warm_s,
                       card, ate_bound_m=KITTI_ATE_BOUND,
                       lost_frames=[round(e.timestamp * 10) for e in slam.trajectory.entries if e.lost],
                       bench_keys=out)
    log(f"KITTI async (bench.py's KITTI leg): {rec['tracked']}/{KITTI_FRAMES} tracked (lost: {rec['lost_frames']}), "
        f"{slam.n_kf_host} keyframes, ATE {ate:.4f} m (bound {KITTI_ATE_BOUND:.4f}), track ms p50 "
        f"{rec['track_ms_p50']:.1f} p90 {rec['track_ms_p90']:.1f} p99 {rec['track_ms_p99']:.1f} max "
        f"{rec['track_ms_max']:.1f}, map ms p50 {rec['map_ms_p50']}, {rec['fps']:.2f} frames/s, reads/frame tracker "
        f"{rec['tracker_reads_per_frame']:.1f} workers {rec['worker_reads_per_frame']:.1f}, launches {launches} by "
        f"thread {by_role}, warmup {warm_s:.1f} s, {card}")
    check_async(rec, launches, by_role, slam, 2)
    if rec["tracked"] < KITTI_MIN_TRACKED:
        raise AssertionError(f"KITTI async: tracked {rec['tracked']}/{KITTI_FRAMES} < {KITTI_MIN_TRACKED}")
    if not ate <= KITTI_ATE_BOUND:
        raise AssertionError(f"KITTI async: ATE {ate:.4f} m > {KITTI_ATE_BOUND:.4f} m")
    return rec, launches, out


def _turn_deg(Ra, Rb):
    import numpy as np

    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1))))


def run_save_load(slam, imgs, deps, gt, card):
    """Phase 13: phase 11's map saved and loaded by a fresh system of the same
    mode, which starts LOST, relocalizes as the live map does on the probe
    frames, and relocalizes a restart within RELOC_TRIES frames."""
    import tempfile

    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch.models import frontend, map_state, relocalization
    from orb_slam2v2_1_tpu_torch.models.system import SlamSystem, TrackState
    from orb_slam2v2_1_tpu_torch.utils import serialization

    n = imgs.shape[0]
    live = {round(t * ASYNC_FPS): T for t, T in slam.trajectory.absolute_poses(slam.map.kf_pose.cpu().numpy())}
    R_ref = slam.map.kf_pose[slam.ref_kf].cpu().numpy()[:3, :3]
    probe = {"relocalized": [], "not_relocalized": []}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "orbit_map.npz")
        t0 = time.perf_counter()
        slam.save_map(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        data = np.load(path)
        for k, v in map_state.to_numpy(slam.map).items():
            if not (data[f"map_{k}"].dtype == v.dtype and np.array_equal(data[f"map_{k}"], v)):
                raise AssertionError(f"save/load: the saved {k} differs from the live map's")
        fresh = SlamSystem(config=slam.config, sensor=slam.sensor, async_mapping=True, pipelined=True)
        try:
            t0 = time.perf_counter()
            fresh.load_map(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            state_after_load = fresh.state
            n_db = int(fresh.loop_closer.db.valid.sum())
            c, fid = fresh.config, fresh.frame_id
            live_db = serialization.rebuild_database(slam.map, slam.vocab, c.max_keyframes, c.n_features)
            t0 = time.perf_counter()
            same_tcw = 0.0
            for k in range(0, n, RELOC_PROBE_STEP):
                frame = frontend.build_frame_only(imgs[k], deps[k], fresh._K, fresh._dist, fresh._bf, fid,
                                                  fresh._orb_cfg, c.width, c.height)
                a = relocalization.relocalize(slam.map, live_db, slam.vocab, frame, slam._K, slam._bf, fid)
                b = relocalization.relocalize(fresh.map, fresh.loop_closer.db, fresh.vocab, frame, fresh._K,
                                              fresh._bf, fid)
                if a[0] != b[0] or a[3] != b[3] or (a[0] and not torch.equal(a[2], b[2])):
                    raise AssertionError(f"save/load: frame {k} relocalized {a[0]} on keyframe {a[3]} in the live map, "
                                         f"{b[0]} on keyframe {b[3]} in the loaded one")
                if a[0]:
                    same_tcw = max(same_tcw, float((a[1] - b[1]).abs().max()))
                probe["relocalized" if a[0] else "not_relocalized"].append(k)
            probe_s = time.perf_counter() - t0
            restart = next((k for k in probe["relocalized"] if all(j in live for j in range(k, k + RELOC_TRIES))
                            and min(_turn_deg(live[k][:3, :3], np.eye(3)),
                                    _turn_deg(live[k][:3, :3], R_ref.T)) > RELOC_MIN_TURN_DEG), None)
            if restart is None:
                raise AssertionError(f"save/load: the live map relocalized none of the probe frames turned more than "
                                     f"{RELOC_MIN_TURN_DEG} deg from its origin and reference keyframe "
                                     f"(relocalized: {probe['relocalized']})")
            outs = []
            for k in range(restart, restart + RELOC_TRIES):
                outs.append(fresh.track_rgbd(imgs[k], deps[k], 20.0 + k / ASYNC_FPS))
                if outs[-1] is not None:
                    break
            fresh.flush()
            n_reloc = fresh.n_relocalized
            kf = fresh.ref_kf
            kf_frame = int(fresh.map.kf_frame_id[kf])
            Tcw_kf = fresh.map.kf_pose[kf].cpu().numpy().astype(np.float64)
        finally:
            fresh.shutdown()
    fed = list(range(restart, restart + len(outs)))
    got, k = outs[-1], fed[-1]
    rot_err = d_t = d_r = off_t = None
    if got is not None:
        Tcw = np.asarray(got.cpu() if hasattr(got, "cpu") else got, np.float64)
        rot_err = _turn_deg(Tcw[:3, :3], (gt[k] @ np.linalg.inv(gt[0]))[:3, :3])
        # The camera's motion from the keyframe's frame to frame k: estimated
        # against the ground truth's.
        rel = Tcw @ np.linalg.inv(Tcw_kf)
        rel_gt = gt[k].astype(np.float64) @ np.linalg.inv(gt[kf_frame].astype(np.float64))
        d_t = float(np.linalg.norm(rel[:3, 3] - rel_gt[:3, 3]))
        d_r = _turn_deg(rel[:3, :3], rel_gt[:3, :3])
        off_t = float(np.linalg.norm(np.linalg.inv(Tcw)[:3, 3] - live[k][:3, 3]))
    n_probe = len(probe["relocalized"]) + len(probe["not_relocalized"])
    rec = {"file_bytes": size, "save_s": save_s, "load_s": load_s, "state_after_load": state_after_load.name,
           "database_keyframes": n_db, "keyframes": slam.n_kf_host, "probe_step": RELOC_PROBE_STEP, "probe": probe,
           "probe_max_tcw_diff": same_tcw, "probe_s": probe_s, "frames_fed": fed, "relocalized": n_reloc,
           "relocalized_on_keyframe": kf, "keyframe_frame": kf_frame, "motion_error_m": d_t,
           "motion_error_deg": d_r, "pose_bound": list(RELOC_POSE_BOUND), "from_phase_11_m": off_t,
           "rotation_error_deg": rot_err, "card": card}
    log(f"save/load: {size} bytes saved in {save_s:.2f} s, equal to the live map; loaded in {load_s:.2f} s, "
        f"{state_after_load.name} after the load, database rebuilt with {n_db} keyframes; probe of every "
        f"{RELOC_PROBE_STEP}th frame: {len(probe['relocalized'])}/{n_probe} relocalized in the live map and the "
        f"same in the loaded one (max |dTcw| {same_tcw:.2e}; not relocalized: {probe['not_relocalized']}), "
        f"{probe_s:.1f} s; restart: orbit frames {fed} fed, {n_reloc} relocalization, on keyframe {kf} (frame "
        f"{kf_frame}): motion from it {d_t} m and {d_r} deg off the ground truth's (bound {RELOC_POSE_BOUND[0]} m, "
        f"{RELOC_POSE_BOUND[1]} deg); {off_t} m from phase 11's camera center of frame {k}, rotation {rot_err} deg "
        f"from the ground truth, {card}")
    if state_after_load != TrackState.LOST or n_db != slam.n_kf_host:
        raise AssertionError(f"save/load: {state_after_load.name} after the load, {n_db} keyframes in the database")
    if not same_tcw <= RELOC_SAME_TCW:
        raise AssertionError(f"save/load: relocalized poses differ by {same_tcw:.2e} between the live and loaded map")
    if got is None or n_reloc < 1:
        raise AssertionError(f"save/load: no relocalization on orbit frames {fed}")
    if not (d_t <= RELOC_POSE_BOUND[0] and d_r <= RELOC_POSE_BOUND[1]):
        raise AssertionError(f"save/load: frame {k} relocalized on keyframe {kf} (frame {kf_frame}) with a motion "
                             f"{d_t:.4f} m, {d_r:.2f} deg off the ground truth's")
    return rec


def _timed_s(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_sharded_gba(card):
    """Phase 19a: the production-scale problem through the sharded full LM
    schedule on meshes of 1, 2 and 4 virtual shards of the card and through
    a world-size-1 NCCL group, against `ops.ba.bundle_adjust` on the card;
    ms per 3-iteration LM chunk by mesh size, beside the single-device
    chunk's."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from orb_slam2v2_1_tpu_torch import sync
    from orb_slam2v2_1_tpu_torch.ops import ba
    from orb_slam2v2_1_tpu_torch.parallel import dist_ba
    from orb_slam2v2_1_tpu_torch.parallel.mesh import Mesh
    from orb_slam2v2_1_tpu_torch.utils import synthetic

    prob = synthetic.ba_problem(np.random.default_rng(0), *GBA_PROBLEM)  # no device given: the card
    args = (prob.poses, prob.points, prob.obs, prob.cam_fixed, prob.K, prob.bf)
    (_, cost_ref), single_s = _timed_s(lambda: ba.bundle_adjust(prob, cg_iters=GBA_CG_ITERS))
    cost_ref = float(cost_ref)

    def chunk_ms(fn):
        """Median ms of CHUNK_REPEATS calls of `fn`, each from the problem's
        start (one warm-up call first)."""
        fn()
        return float(np.median([_timed_s(fn)[1] * 1e3 for _ in range(CHUNK_REPEATS)]))

    single_chunk = {name: chunk_ms(lambda dense=dense: sync.host(ba.ba_step_count_lam(
        prob, 1e-4, iters=3, cg_iters=GBA_CG_ITERS, robust=True, dense=dense)[3]))
        for name, dense in (("pcg", False), ("dense", True))}
    rec = {"problem": dict(zip(("cameras", "points", "observations"), GBA_PROBLEM)),
           "valid_observations": int(prob.obs.valid.sum()), "cg_iters": GBA_CG_ITERS,
           "single_device": {"cost": cost_ref, "full_schedule_s": single_s, "chunk_ms": single_chunk},
           "all_reduces_per_lm_iteration": 2 * GBA_CG_ITERS + 5, "host_reads_per_lm_iteration": 1,
           "meshes": {}, "card": card, "note": "virtual shards on one card"}
    outs = {}
    for n in MESH_SHARDS:
        mesh = Mesh([MESH_DEVICE] * n)
        sync.reset()
        out, solve_s = _timed_s(lambda: dist_ba.make_sharded_bundle_adjust(mesh, cg_iters=GBA_CG_ITERS)(*args))
        reads = sync.COUNT["syncs"]
        cost = float(out[3])
        rel = abs(cost - cost_ref) / cost_ref
        chunk = dist_ba.get_sharded_lm_chunk(mesh, iters=3, robust=True, cg_iters=GBA_CG_ITERS)
        ms = chunk_ms(lambda: chunk(*args, 1e-4))
        outs[n] = out
        rec["meshes"][n] = {"cost": cost, "rel_to_single": rel, "full_schedule_s": solve_s, "host_reads": reads,
                            "chunk_ms": ms, "inliers": int(out[2].sum())}
        log(f"sharded GBA, {n} virtual shard(s) of the card: cost {cost:.3f} (single device {cost_ref:.3f}, "
            f"rel {rel:.2e}), full schedule {solve_s:.2f} s ({reads} host reads), {ms:.1f} ms per 3-iteration "
            f"LM chunk (single device: PCG {single_chunk['pcg']:.1f}, dense {single_chunk['dense']:.1f})")
        if not (torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all() and np.isfinite(cost)):
            raise AssertionError(f"sharded GBA on {n} shards: values not finite")
        if not rel < GBA_COST_REL:
            raise AssertionError(f"sharded GBA on {n} shards: cost {cost} vs single device {cost_ref} (rel {rel:.4f})")

    # One rank of NCCL on the card: the group's all-reduce runs for real.
    store_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(store_dir, "nccl_store")
    if os.path.exists(store_path):
        os.remove(store_path)
    dist.init_process_group(GROUP_BACKEND, store=dist.FileStore(store_path, 1), rank=0, world_size=1)
    try:
        nccl_mesh = Mesh([MESH_DEVICE], group=dist.group.WORLD)
        nccl_out, nccl_s = _timed_s(lambda: dist_ba.make_sharded_bundle_adjust(nccl_mesh, cg_iters=GBA_CG_ITERS)(*args))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(a, b) for a, b in zip(nccl_out, outs[1]))
    rec["nccl_world_size_1"] = {"backend": backend, "cost": float(nccl_out[3]), "full_schedule_s": nccl_s,
                                "equal_to_in_process": same}
    log(f"sharded GBA through a world-size-1 {backend} group: cost {float(nccl_out[3]):.3f}, {nccl_s:.2f} s, "
        f"equal to the in-process 1-shard run: {same}, {card}")
    if not same:
        raise AssertionError("the NCCL run differs from its in-process twin")
    return rec


def _route_counts():
    from orb_slam2v2_1_tpu_torch.parallel import dist_ba

    return {f"{role}/{label}": n for (role, label), n in sorted(dist_ba.SOLVES.items())}


def run_mesh_sync_orbit(imgs, deps, gt, cfg, card):
    """Phase 19b: phase 11's configuration in sync mode with its loop closer
    over all 321 orbit frames on a mesh of virtual shards of the card."""
    import dataclasses

    from orb_slam2v2_1_tpu_torch.models.system import Sensor, SlamSystem
    from orb_slam2v2_1_tpu_torch.parallel import dist_ba

    slam = SlamSystem(config=dataclasses.replace(cfg, fps=ASYNC_FPS), sensor=Sensor.RGBD,
                      mesh=[MESH_DEVICE] * MESH_SYNC_SHARDS)  # no device given: the card
    inserted = []
    insert = slam._insert_keyframe_fused

    def counted_insert(frame):
        inserted.append(1)
        return insert(frame)

    slam._insert_keyframe_fused = counted_insert
    dist_ba.reset_counts()
    outs, _, wall, launches, syncs = drive(slam, list(zip(imgs, deps)), slam.track_rgbd)
    routes = _route_counts()
    n = len(outs)
    ate = ate_of(slam, {j * 0.1: T for j, T in enumerate(gt)})
    closures = len(slam.loop_closer.closures)
    rec = online_record(slam, n, n_posed(outs), wall, launches, syncs, ate, card, mesh_shards=MESH_SYNC_SHARDS,
                        ate_bound_m=MESH_SYNC_ATE_BOUND, reference_sync_ate_m=ONLINE_SYNC_REF_ATE,
                        keyframes_inserted=len(inserted), closures=slam.loop_closer.closures, sharded_solves=routes)
    log(f"mesh sync orbit ({MESH_SYNC_SHARDS} virtual shards): {rec['tracked']}/{n} tracked, {slam.n_kf_host} "
        f"keyframes ({len(inserted)} inserted), {slam.n_loops_closed} loops {slam.loop_closer.closures}, ATE "
        f"{ate:.4f} m (bound {MESH_SYNC_ATE_BOUND:.4f}), sharded solves {routes}, track ms p50 "
        f"{rec['track_ms_p50']:.1f} p90 {rec['track_ms_p90']:.1f}, map ms p50 {rec['map_ms_p50']}, "
        f"{rec['fps']:.2f} frames/s, host reads {syncs / n:.1f}/frame, launches {launches}, {card}")
    if rec["tracked"] < 0.9 * n:
        raise AssertionError(f"mesh sync orbit: tracked {rec['tracked']}/{n} < 90%")
    if slam.n_loops_closed < 1:
        raise AssertionError("mesh sync orbit: no loop closed")
    if not ate <= MESH_SYNC_ATE_BOUND:
        raise AssertionError(f"mesh sync orbit: ATE {ate:.4f} m > {MESH_SYNC_ATE_BOUND:.4f} m")
    if routes.get("tracker/local_ba", 0) != len(inserted) or not inserted:
        raise AssertionError(f"mesh sync orbit: {len(inserted)} keyframes inserted, sharded local BAs {routes}")
    if routes.get("tracker/global_ba", 0) != closures:
        raise AssertionError(f"mesh sync orbit: {closures} closures, sharded global BAs {routes}")
    for kernel, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {kernel} was not launched by the mesh sync orbit")
    return rec, launches, slam


def run_mesh_runner(slam, card):
    """Phase 19c: the detached global-BA runner sharded over the mesh on
    (b)'s final map, against the single-device runner on the same snapshot."""
    import torch
    from orb_slam2v2_1_tpu_torch.models import loop_closing as lc
    from orb_slam2v2_1_tpu_torch.ops import ba

    snap = slam.map
    rec = {"mesh_shards": MESH_SYNC_SHARDS, "card": card}
    costs = {}
    for name, mesh in (("single", None), ("mesh", [MESH_DEVICE] * MESH_SYNC_SHARDS)):
        runner = lc.GlobalBARunner(slam._K, slam._bf, mesh=mesh)
        runner.start(snap)
        runner.join(600.0)
        if runner.running or runner.aborted or runner.result is None:
            raise AssertionError(f"{name} GBA runner: running {runner.running}, aborted {runner.aborted}")
        merged = lc.merge_gba_into_live(snap, *runner.result)
        prob = lc.build_global_ba_problem(merged, slam._K, slam._bf)
        costs[name] = float(ba._cost(prob, False, prob.obs.valid.to(torch.float32)))
        rec[name] = {"cost": costs[name], "solve_ms": runner.solve_ms[-1], "chunks": len(runner.chunk_ms),
                     "chunk_ms_median": sorted(runner.chunk_ms)[len(runner.chunk_ms) // 2]}
        if not torch.isfinite(merged.kf_pose).all():
            raise AssertionError(f"{name} GBA runner: poses not finite")
    before = lc.build_global_ba_problem(snap, slam._K, slam._bf)
    rec["cost_before"] = float(ba._cost(before, False, before.obs.valid.to(torch.float32)))
    rel = abs(costs["mesh"] - costs["single"]) / costs["single"]
    rec["rel"] = rel
    log(f"detached GBA runner on the orbit's map: cost before {rec['cost_before']:.1f}, single device "
        f"{costs['single']:.1f} in {rec['single']['solve_ms']:.0f} ms, {MESH_SYNC_SHARDS} virtual shards "
        f"{costs['mesh']:.1f} in {rec['mesh']['solve_ms']:.0f} ms (rel {rel:.2e}), {card}")
    if not rel < GBA_COST_REL:
        raise AssertionError(f"sharded GBA runner: cost {costs['mesh']} vs single device {costs['single']}")
    return rec


def run_mesh_async_desk(cfg, card):
    """Phase 19d: clean_desk_rgbd in async mode on a mesh of virtual shards
    of the card; the mapping worker solves its windows through the mesh."""
    from orb_slam2v2_1_tpu_torch.models.system import Sensor, SlamSystem
    from orb_slam2v2_1_tpu_torch.parallel import dist_ba
    from orb_slam2v2_1_tpu_torch.utils import synthetic

    imgs, deps, gt = synthetic.desk_frames(cfg, synthetic.desk_trajectory(DESK_FRAMES))  # no device given: the card
    slam = SlamSystem(config=cfg, sensor=Sensor.RGBD, async_mapping=True, mesh=[MESH_DEVICE] * MESH_ASYNC_SHARDS)
    dist_ba.reset_counts()
    try:
        outs, _, wall, launches, syncs = drive(slam, list(zip(imgs, deps)), slam.track_rgbd)
        slam.flush()
    finally:
        slam.shutdown()
    routes = _route_counts()
    n = len(outs)
    ate = ate_of(slam, {j * 0.1: T for j, T in enumerate(gt)})
    tracked = sum(not e.lost for e in slam.trajectory.entries)
    rec = online_record(slam, n, n_posed(outs), wall, launches, syncs, ate, card, mesh_shards=MESH_ASYNC_SHARDS,
                        ate_bound_m=DESK_ATE_BOUND, tracked_entries=tracked, sharded_solves=routes)
    log(f"mesh async clean_desk_rgbd ({MESH_ASYNC_SHARDS} virtual shards): {tracked}/{n} tracked, "
        f"{slam.n_kf_host} keyframes, ATE {ate:.5f} m (bound {DESK_ATE_BOUND:.5f}), sharded solves {routes}, "
        f"track ms p50 {rec['track_ms_p50']:.1f}, {rec['fps']:.2f} frames/s, launches {launches}, {card}")
    if tracked != n:
        raise AssertionError(f"mesh async desk: tracked {tracked}/{n}")
    if not ate <= DESK_ATE_BOUND:
        raise AssertionError(f"mesh async desk: ATE {ate:.5f} m > {DESK_ATE_BOUND:.5f} m")
    if routes.get("mapping/local_ba", 0) < 1 or routes.get("tracker/local_ba", 0):
        raise AssertionError(f"mesh async desk: the mapping worker's windows were not solved on the mesh: {routes}")
    for kernel, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {kernel} was not launched by the mesh async desk")
    return rec, launches


def run_evaluate_quick(card):
    """Phase 20: the accuracy harness's entry point, `python -m
    orb_slam2v2_1_tpu_torch.evaluate --quick --frames 40 --out
    build/chip_smoke/EVAL.json`, as a subprocess on the card: exit 0, every
    gate passed, each leg's tracked count at least its floor, fast_score_nms
    launched once per frame (counted by the subprocess)."""
    import subprocess

    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "EVAL.json")
    if os.path.exists(path):
        os.remove(path)
    cmd = [sys.executable, "-c", MODULE_WRAPPER, "orb_slam2v2_1_tpu_torch.evaluate", *EVAL_QUICK_ARGS, "--out", path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=EVAL_QUICK_TIMEOUT_S)
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, "evaluate_quick.txt"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"evaluate {' '.join(EVAL_QUICK_ARGS)} exited {proc.returncode}: {proc.stderr[-3000:]}")
    with open(path) as f:
        ev = json.load(f)
    launches = printed_launches(proc.stdout)
    seqs, gates = ev["sequences"], ev["gates"]
    for name, r in seqs.items():
        g = gates.get(name, {})
        log(f"evaluate {' '.join(EVAL_QUICK_ARGS)}, {name}: {r['tracked']}/{r['frames']} tracked (post-init share "
            f"{r['tracked_frac_post_init']}, floor {EVAL_QUICK_MIN_TRACKED.get(name)}), {r['n_kf']} keyframes, "
            f"{r['n_resets']} resets, ATE {r['ate_rmse_m']} m (bound {g.get('bound')}, pass {g.get('pass')}), "
            f"wall {r['wall_s']} s")
    n_frames = sum(r["frames"] for r in seqs.values())
    log(f"evaluate {' '.join(EVAL_QUICK_ARGS)}: exit 0, all_pass {ev['all_pass']}, {wall:.1f} s with start-up, "
        f"launches {launches} for {n_frames} frames, {card}")
    if not ev["all_pass"] or sorted(gates) != sorted(seqs):
        raise AssertionError(f"evaluate: gates {gates}")
    if sorted(seqs) != sorted(EVAL_QUICK_MIN_TRACKED):
        raise AssertionError(f"evaluate --quick ran the legs {sorted(seqs)}")
    for name, floor in EVAL_QUICK_MIN_TRACKED.items():
        if seqs[name]["tracked"] < floor:
            raise AssertionError(f"evaluate: {name} tracked {seqs[name]['tracked']} < {floor}")
    if launches["fast_score_nms"] != n_frames or launches["masked_best_two"] <= 0:
        raise AssertionError(f"evaluate: launches {launches} for {n_frames} frames")
    return {"args": list(EVAL_QUICK_ARGS), "eval": ev, "wall_s": wall, "launches": launches,
            "min_tracked": EVAL_QUICK_MIN_TRACKED, "card": card}, launches


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
    from orb_slam2v2_1_tpu_torch import bench, kernels, sync
    from orb_slam2v2_1_tpu_torch import kernel_times as kt
    from orb_slam2v2_1_tpu_torch.models import offline
    from orb_slam2v2_1_tpu_torch.ops import orb
    from orb_slam2v2_1_tpu_torch.utils import config, synthetic

    cfg = config.SlamConfig(**kt.BENCH)
    ocfg = orb.OrbConfig(n_features=cfg.n_features, n_levels=cfg.n_levels, scale=cfg.scale_factor,
                         fast_threshold=cfg.fast_threshold, fast_min_threshold=cfg.fast_min_threshold)
    dev = torch.device("cuda", 0)
    card = kt.card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(card)

    t_start = t0 = time.perf_counter()
    build_s = kernels.build(verbose=True)
    log(f"kernel build: {build_s:.1f} s (nvcc), set-up total {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    all_imgs, all_deps, all_gt = synthetic.orbit_frames(cfg, LOOP_FRAMES, total=kt.ORBIT_TOTAL)  # no device given: the card
    torch.cuda.synchronize()
    log(f"rendered {LOOP_FRAMES} orbit frames on the card in {time.perf_counter() - t0:.1f} s")
    if not (all_imgs.is_cuda and torch.isfinite(all_imgs).all() and (all_deps > 0).float().mean() > 0.99):
        raise AssertionError("rendered frames are not on the card, not finite or lack depth")
    imgs, deps, gt = all_imgs[:N_FRAMES], all_deps[:N_FRAMES], all_gt[:N_FRAMES]

    rng = np.random.default_rng(0)
    floor_ms = kt.graph_us(lambda: kernels.empty_launch(dev)) / 1e3
    log(f"empty kernel: device {floor_ms:.5f} ms per launch (the floor under both bounds), "
        f"with wrapper {kt.wrapper_us(lambda: kernels.empty_launch(dev)) / 1e3:.4f} ms")
    noise = torch.from_numpy(rng.uniform(0, 255, (cfg.height, cfg.width)).astype(np.float32)).to(dev)
    fast_res = check_fast(kt, imgs[0].contiguous(), noise, cfg, ocfg, floor_ms)
    kcfg = config.SlamConfig(**kt.KITTI)
    kocfg = orb.OrbConfig(n_features=kcfg.n_features, n_levels=kcfg.n_levels, scale=kcfg.scale_factor,
                          fast_threshold=kcfg.fast_threshold, fast_min_threshold=kcfg.fast_min_threshold)
    kitti_img = synthetic.stereo_dolly_frames(kcfg, [0], np.random.default_rng(3), dx=KITTI_STEP[0], dz=KITTI_STEP[1])[0][0]
    kitti_noise = torch.from_numpy(rng.uniform(0, 255, (kcfg.height, kcfg.width)).astype(np.float32)).to(dev)
    fast_res["shapes"] += check_fast(kt, kitti_img.contiguous(), kitti_noise, kcfg, kocfg, floor_ms, " (KITTI)")["shapes"]
    match_res = check_match(kt, dev, rng, floor_ms)
    pose_res = check_pose(kt, dev, rng, floor_ms)

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
    ate, ate_anchored = orbit_ate(poses, ok, gt)
    c_est = centers(poses)
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
    if launches["fast_score_nms"] != N_FRAMES:
        raise AssertionError(f"fast_score_nms: {launches['fast_score_nms']} launches for {N_FRAMES} frames, expected one each")
    if launches["pose_lm"] < 2 * (n_ok - 1):
        raise AssertionError(f"pose_lm: {launches['pose_lm']} launches for {n_ok - 1} tracked frames after the first, "
                             "expected at least two each")

    # --- the same frames through the plain versions on the CPU ---
    cpu_poses, cpu_ok, _ = offline.track_sequence_rgbd(
        imgs[:CPU_CHECK_FRAMES].cpu().numpy(), deps[:CPU_CHECK_FRAMES].cpu().numpy(), cfg, device="cpu")
    dc = np.linalg.norm(centers(cpu_poses) - c_est[:CPU_CHECK_FRAMES], axis=1).max()
    log(f"CPU plain path, frames 0-{CPU_CHECK_FRAMES - 1}: ok {cpu_ok.tolist()}, max center diff {dc:.2e} m")
    if not (np.array_equal(cpu_ok, ok[:CPU_CHECK_FRAMES]) and dc <= 2e-3):
        raise AssertionError("the card's path disagrees with the CPU plain path")

    # --- the loop path ---
    loop_rec, loop_launches, loop_poses, loop_ok, headline = run_loop_path(all_imgs, all_deps, all_gt, cfg, card)

    # --- the online entry point: RGB-D with relocalization, stereo dolly, KITTI geometry ---
    online_rec, online_launches = run_online_rgbd(all_imgs, all_deps, all_gt, cfg, card)
    online_rec["pnp_on_card"] = check_pnp_on_card(dev)
    dolly_rec, dolly_launches = run_stereo("stereo dolly", cfg, DOLLY_FRAMES, DOLLY_STEP, DOLLY_ATE_BOUND,
                                              DOLLY_FRAMES, card, cpu_check=True)
    kitti_rec, kitti_launches = run_stereo("KITTI geometry", kcfg, KITTI_FRAMES, KITTI_STEP, KITTI_ATE_BOUND,
                                              KITTI_MIN_TRACKED, card)
    for name, counts in (("online", online_launches), ("stereo dolly", dolly_launches), ("KITTI", kitti_launches)):
        for kernel, count in counts.items():
            if count <= 0:
                raise AssertionError(f"kernel {kernel} was not launched by the {name} path")

    # --- evaluate.py's clean desk legs: RGB-D and monocular ---
    import dataclasses

    from orb_slam2v2_1_tpu_torch.models.system import Sensor

    ecfg = config.SlamConfig(**kt.EVAL)
    desk_rec, desk_launches = run_desk("clean_desk_rgbd", ecfg, Sensor.RGBD, synthetic.desk_trajectory(DESK_FRAMES),
                                       DESK_ATE_BOUND, card)
    if desk_rec["tracked"] < DESK_REF_TRACKED:
        raise AssertionError(f"clean_desk_rgbd: tracked {desk_rec['tracked']} < the reference's {DESK_REF_TRACKED}")
    mono_rec, mono_launches = run_desk("clean_mono", dataclasses.replace(ecfg, bf=0.0), Sensor.MONOCULAR,
                                       synthetic.lateral_trajectory(MONO_FRAMES), MONO_ATE_BOUND, card)
    if mono_rec["tracked_share_post_init"] < 1.0 or mono_rec["tracked"] < MONO_REF_TRACKED - 2:
        raise AssertionError(f"clean_mono: tracked {mono_rec['tracked']} (post-init share "
                             f"{mono_rec['tracked_share_post_init']:.3f}), the reference {MONO_REF_TRACKED}")

    # --- bench.py's online and KITTI legs in its production mode, and the map saved and loaded ---
    oa_rec, oa_launches, oa_slam, oa_out = run_online_async(all_imgs, all_deps, all_gt, cfg, card)
    ka_rec, ka_launches, ka_out = run_kitti_async(card)
    # bench's JSON line from phase 5's headline run and the legs of phases 11-12.
    bench_line = bench.result_line(*headline, {**oa_out, **ka_out})
    log("bench line (phase 5's one headline run without warm-up, phases 11-12's legs): " + json.dumps(bench_line))
    missing = [k for k in BENCH_KEYS if k not in bench_line]
    if missing:
        raise AssertionError(f"the bench line lacks {missing}")
    oa_rec["save_load"] = run_save_load(oa_slam, all_imgs, all_deps, all_gt, card)
    del oa_slam

    # --- evaluate.py's adversarial legs, gated against their clean twins of this run ---
    def norm(ps):
        return [p @ np.linalg.inv(ps[0]) for p in ps]

    rng21 = np.random.default_rng(21)
    adv_scene = synthetic.make_adversarial(rng21)
    adv_rgbd_rec, adv_rgbd_launches = run_adversarial(
        "adv_clutter_rgbd", ecfg, Sensor.RGBD, adv_scene, norm(synthetic.desk_trajectory(DESK_FRAMES, extent=0.55)),
        rng21, desk_rec["ate_m"], card)
    adv_mono_rec, adv_mono_launches = run_adversarial(
        "adv_mono", dataclasses.replace(ecfg, bf=0.0), Sensor.MONOCULAR,
        synthetic.make_adversarial(np.random.default_rng(22), max_tilt_deg=35.0),
        norm(synthetic.lateral_trajectory(MONO_FRAMES, extent=0.9)), np.random.default_rng(33), mono_rec["ate_m"],
        card)
    adv_st_rec, adv_st_launches = run_adversarial(
        "adv_stereo_dolly", cfg, Sensor.STEREO, synthetic.make_room(np.random.default_rng(3)),
        [synthetic.dolly_pose(i, *DOLLY_STEP) for i in range(DOLLY_FRAMES)], np.random.default_rng(43),
        dolly_rec["ate_m"], card)

    # --- the command-line runner on a written dataset, and two sessions on a map server ---
    cli_rec, cli_launches = run_cli(ecfg, card)
    server_rec, merge_launches = run_two_sessions(ecfg, card)

    # --- the bundle adjustment sharded over a mesh of virtual shards of the card ---
    gba_rec = run_sharded_gba(card)
    mesh_sync_rec, mesh_sync_launches, mesh_slam = run_mesh_sync_orbit(all_imgs, all_deps, all_gt, cfg, card)
    mesh_sync_rec["detached_runner"] = run_mesh_runner(mesh_slam, card)
    del mesh_slam
    mesh_async_rec, mesh_async_launches = run_mesh_async_desk(ecfg, card)

    # --- the accuracy harness's entry point, as a subprocess ---
    torch.cuda.empty_cache()
    eval_rec, eval_launches = run_evaluate_quick(card)

    # --- the RANSAC draws on the card against the CPU ---
    draw_rec = check_draws(kt, dev, card)

    if out_dir:
        profile(offline, imgs, deps, cfg, out_dir)
        profile_loop(all_imgs, all_deps, cfg, dev, out_dir)
        t0 = time.perf_counter()
        plain_poses, plain_ok, plain_state = offline.track_sequence_rgbd(all_imgs, all_deps, cfg)
        wall = time.perf_counter() - t0
        log(f"profile, the {LOOP_FRAMES} frames without a loop closer: {int(plain_ok.sum())}/{LOOP_FRAMES} tracked, "
            f"{int(plain_state.kf_valid.sum())} keyframes, ATE {orbit_ate(plain_poses, plain_ok, all_gt)[0]:.4f} m, "
            f"{LOOP_FRAMES / wall:.2f} frames/s")
        np.savez(os.path.join(out_dir, "chip_smoke_poses.npz"), poses=poses, ok=ok,
                 loop_poses=loop_poses, loop_ok=loop_ok)

    def entry(name, res, src, replaces):
        return {"name": name, "route": "cuda", "source": f"orb_slam2v2_1_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": loop_launches[name],
                "launches_by_path": {"rgbd_96_frames": launches[name], "loop_321_frames": loop_launches[name],
                                     "online_rgbd": online_launches[name], "stereo_dolly": dolly_launches[name],
                                     "stereo_kitti": kitti_launches[name], "clean_desk_rgbd": desk_launches[name],
                                     "clean_mono": mono_launches[name], "online_async": oa_launches[name],
                                     "kitti_async": ka_launches[name], "adv_clutter_rgbd": adv_rgbd_launches[name],
                                     "adv_mono": adv_mono_launches[name], "adv_stereo_dolly": adv_st_launches[name],
                                     "cli_run_slam": cli_launches[name],
                                     "two_sessions": [r["launches"][name] for r in server_rec["sessions"]],
                                     "mesh_sync_orbit": mesh_sync_launches[name],
                                     "mesh_async_desk": mesh_async_launches[name],
                                     "evaluate_quick_40": eval_launches[name]},
                "launches_by_thread": {"online_async": oa_rec["launches_by_thread"][name],
                                       "kitti_async": ka_rec["launches_by_thread"][name],
                                       "two_sessions_merge": merge_launches[name]},
                "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": None,
                "wrapper_ms": res["wrapper_ms"], "empty_launch_ms": floor_ms, "shapes": res["shapes"]}

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({
        "kernels": [entry("fast_score_nms", fast_res, "fast_score_nms.cu", "orb_slam2v2_1_tpu/ops/pallas_kernels.py:138"),
                    entry("masked_best_two", match_res, "masked_best_two.cu", "orb_slam2v2_1_tpu/ops/pallas_kernels.py:225"),
                    entry("pose_lm", pose_res, "pose_lm.cu",
                          "no Pallas kernel: the compiled while_loop of orb_slam2v2_1_tpu/ops/ba.py:132")],
        "main_path": {"frames": N_FRAMES, "tracked": n_ok, "keyframes": n_kf, "map_points": n_mp,
                      "ate_m": ate, "ate_anchored_m": ate_anchored, "wall_s": wall,
                      "fps": N_FRAMES / wall, "host_syncs": syncs, "card": card},
        "loop_path": loop_rec,
        "online_rgbd": online_rec,
        "stereo_dolly": dolly_rec,
        "stereo_kitti": kitti_rec,
        "clean_desk_rgbd": desk_rec,
        "clean_mono": mono_rec,
        "online_async": oa_rec,
        "kitti_async": ka_rec,
        "adv_clutter_rgbd": adv_rgbd_rec,
        "adv_mono": adv_mono_rec,
        "adv_stereo_dolly": adv_st_rec,
        "cli_run_slam": cli_rec,
        "two_sessions": server_rec,
        "sharded_gba": gba_rec,
        "mesh_sync_orbit": mesh_sync_rec,
        "mesh_async_desk": mesh_async_rec,
        "bench_line": bench_line,
        "evaluate_quick": eval_rec,
        "draws": draw_rec,
    }, default=str), flush=True)
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
        f"in {n_kernels} kernels ({n_kernels / n:.0f} per frame), device busy share {dev_ms / (wall * 1e3):.3f}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_main_path.txt"), "w") as f:
        f.write(avg.table(sort_by="self_device_time_total", row_limit=40))
        f.write(avg.table(sort_by="cpu_time_total", row_limit=60))


def loop_rounds(imgs, deps, cfg, dev, profiled):
    """The loop path with every loop round (the stage between two chunks of
    frames: database update, detection, Sim3, correction, fusion, global-BA
    service) timed on the host's clock or, if `profiled`, under
    torch.profiler's device tracing. Returns (one row per round, wall
    seconds, the closer). Unprofiled rows hold the tracker's ms per frame of
    the chunk before the round, whether the global-BA worker ran beside that
    chunk, the round's wall time, host reads, events and the wall time of each
    stage of a closure (`compute_sim3` per candidate, `correct_loop`,
    `search_and_fuse`); profiled rows the round's kernels and device time
    (the profiler sees the whole card, so they include the worker's while a
    solve is in flight, and its overhead makes the profiled wall times
    useless)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from orb_slam2v2_1_tpu_torch import bench, sync
    from orb_slam2v2_1_tpu_torch.models import loop_closing, offline

    closer = bench.make_loop_closer(cfg, device=dev)
    runner = closer.gba_runner
    rows, mark = [], {}
    real_round = offline._loop_round
    # The stages of a closure, timed on the host's clock in the unprofiled pass.
    stages = {name: getattr(loop_closing, name) for name in ("compute_sim3", "correct_loop", "search_and_fuse")}
    stage_ms = {}

    def timed_stage(name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = stages[name](*args, **kwargs)
            torch.cuda.synchronize()
            stage_ms.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    def start_chunk():
        torch.cuda.synchronize()
        mark.update(t=time.perf_counter(), syncs=sync.COUNT["syncs"], beside_solve=runner.running)

    def traced_round(loop_closer, carry, last_seq):
        torch.cuda.synchronize()
        row = {"track_ms_per_frame": 1e3 * (time.perf_counter() - mark["t"]) / LOOP_CHUNK,
               "track_syncs_per_frame": (sync.COUNT["syncs"] - mark["syncs"]) / LOOP_CHUNK,
               "beside_solve": mark["beside_solve"] or runner.running}
        before = (sync.COUNT["syncs"], closer.n_loops_closed, closer.n_gba_merged, runner.n_runs)
        t0 = time.perf_counter()
        if profiled:
            with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
                out = real_round(loop_closer, carry, last_seq)
                torch.cuda.synchronize()
            dev_rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            row.update(kernels=sum(e.count for e in dev_rows),
                       device_ms=sum(e.self_device_time_total for e in dev_rows) / 1e3)
        else:
            out = real_round(loop_closer, carry, last_seq)
            torch.cuda.synchronize()
        row.update(stage_ms={k: [round(x, 1) for x in v] for k, v in stage_ms.items()})
        stage_ms.clear()
        row.update(round_ms=1e3 * (time.perf_counter() - t0), syncs=sync.COUNT["syncs"] - before[0],
                   closed=closer.n_loops_closed - before[1], merged=closer.n_gba_merged - before[2],
                   started=runner.n_runs - before[3])
        rows.append(row)
        start_chunk()
        return out

    offline._loop_round = traced_round
    if not profiled:
        for name in stages:
            setattr(loop_closing, name, timed_stage(name))
    try:
        sync.reset()
        start_chunk()
        t0 = time.perf_counter()
        offline.track_sequence_rgbd(imgs, deps, cfg, loop_closer=closer, chunk=LOOP_CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        offline._loop_round = real_round
        for name, fn in stages.items():
            setattr(loop_closing, name, fn)
    return rows, wall, closer


def profile_loop(imgs, deps, cfg, dev, out_dir):
    """The loop path twice more: once with its loop rounds timed, once with
    them under the profiler for their kernels and device time. Table in
    out_dir/profile_loop_path.txt."""
    rows, wall, closer = loop_rounds(imgs, deps, cfg, dev, profiled=False)
    prof_rows, _, prof_closer = loop_rounds(imgs, deps, cfg, dev, profiled=True)
    runner = closer.gba_runner
    lines = [f"closures {closer.closures}, under the profiler {prof_closer.closures}",
             "chunk  track ms/frame  reads/frame  beside a solve | round ms  reads  closed merged started | kernels  device ms"]
    for i, (r, p) in enumerate(zip(rows, prof_rows)):
        lines.append(f"{i:5d}  {r['track_ms_per_frame']:14.1f}  {r['track_syncs_per_frame']:11.1f}  {str(r['beside_solve']):>14} | "
                     f"{r['round_ms']:8.1f}  {r['syncs']:5d}  {r['closed']:6d} {r['merged']:6d} {r['started']:7d} | "
                     f"{p['kernels']:7d}  {p['device_ms']:9.2f}")
        if r["stage_ms"]:
            lines.append(f"       stages of the closure, ms per call: {r['stage_ms']}")
    beside = [r["track_ms_per_frame"] for r in rows if r["beside_solve"]]
    alone = [r["track_ms_per_frame"] for r in rows if not r["beside_solve"]]
    if beside and alone:
        b, a = sum(beside) / len(beside), sum(alone) / len(alone)
        cost = f"{b:.1f} ms/frame in {len(beside)} chunks beside a solve, {a:.1f} in {len(alone)} without: ratio {b / a:.3f}"
    else:
        cost = "not measured (no chunk ran beside a solve, or every chunk did)"
    solve_s = sum(runner.solve_ms) / 1e3
    lines.append(f"tracker beside the global-BA worker: {cost}; the solves' own wall is {solve_s:.2f} s of {wall:.2f} s "
                 f"({solve_s / wall:.4f}), the most the worker can have cost the tracker")
    lines.append(f"global BA: solves {[round(x, 1) for x in runner.solve_ms]} ms, their chunks of {runner.chunk_iters} LM "
                 f"iterations {[round(x, 1) for x in runner.chunk_ms]} ms; loop rounds {sum(r['round_ms'] for r in rows):.0f} ms "
                 f"of {1e3 * wall:.0f} ms wall")
    for line in lines:
        log("profile, loop path: " + line)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_loop_path.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
