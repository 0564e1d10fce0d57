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
     2000 keypoints, and the monocular motion model at radius 15). Per form: the device time without the host (100 calls
     in one CUDA graph between two events), the wrapper-included time and the
     plain version's (events around one call, median of 20), the bound
     reckoned from this run's inputs, and the empty kernel's launch;
  4. the main path: frames 0-95 of the benchmark's 321-frame RGB-D orbit,
     rendered on the card, through `models.offline.track_sequence_rgbd` at the
     benchmark configuration (640x480, 1000 features, 8 levels, 128 keyframes,
     16384 map points); launch counts of both kernels (fast_score_nms once
     per frame), tracked share, ATE against the orbit's ground truth,
     frames/s; the first frames are also run on the CPU (plain versions) and
     must agree;
  5. the loop path: all 321 frames of the orbit through the same entry point
     with a loop closer built as the benchmark builds it (the shared
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
     gate; kernel 2's motion-model search runs at radius 15.
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
VOCAB_NPZ = os.path.join(ROOT, "orb_slam2v2_1_tpu", "data", "vocab.npz")  # a data file, read in place
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


def make_loop_closer(cfg, dev):
    """The benchmark's loop closer: the shared vocabulary, a database sized by
    the configuration, fixed scale (RGB-D), detached global BA."""
    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch.models import keyframe_database as kdb
    from orb_slam2v2_1_tpu_torch.models.loop_closing import LoopCloser
    from orb_slam2v2_1_tpu_torch.ops import vocab

    voc = vocab.load_vocabulary(np.load(VOCAB_NPZ), device=dev)
    db = kdb.empty_database(cfg.max_keyframes, cfg.n_features, voc.n_words, device=dev)
    closer = LoopCloser(voc, db, fix_scale=True, K=torch.tensor(cfg.K, dtype=torch.float32, device=dev),
                        bf=float(cfg.bf))
    closer.enable_detached_gba()
    return closer


def orbit_ate(poses, ok, gt):
    """(rigid-aligned ATE, first-frame anchored ATE) of the tracked frames."""
    import numpy as np

    gt_rel = np.stack([g @ np.linalg.inv(gt[0]) for g in gt])  # ground truth, world = first camera
    c_est, c_gt = centers(poses), centers(gt_rel)
    return ate_rigid(c_est[ok], c_gt[ok]), float(np.sqrt(np.mean(np.sum((c_est[ok] - c_gt[ok]) ** 2, axis=1))))


def run_loop_path(imgs, deps, gt, cfg, dev, card):
    """Phase 5: the 321 frames with loop closing. Returns the record that
    goes into the kernels line, the launch counts, and the poses."""
    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch import kernels, sync
    from orb_slam2v2_1_tpu_torch.models import offline

    n = imgs.shape[0]
    closer = make_loop_closer(cfg, dev)
    kernels.reset_launch_counts()
    sync.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, ok, state = offline.track_sequence_rgbd(imgs, deps, cfg, loop_closer=closer, chunk=LOOP_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
    return rec, launches, poses, ok


def ate_of(slam, gt_Tcw, align_scale=False):
    """The repository's ATE (`utils.trajectory.ate_rmse`, rigid unless
    `align_scale`) of a SlamSystem's trajectory, resolved with its final
    keyframe poses, against ground-truth Tcw keyed by timestamp."""
    import numpy as np
    from orb_slam2v2_1_tpu_torch.utils.trajectory import ate_rmse

    est = slam.trajectory.absolute_poses(slam.map.kf_pose.cpu().numpy())
    return ate_rmse(est, {t: np.linalg.inv(T) for t, T in gt_Tcw.items()}, align_scale=align_scale)


def online_record(slam, outs, wall, launches, syncs, ate, card, **extra):
    st = slam.stats()
    n = len(outs)
    return {"frames": n, "tracked": sum(o is not None for o in outs), "keyframes": slam.n_kf_host,
            "map_points": int(slam.map.mp_valid.sum()), "loops_closed": slam.n_loops_closed,
            "relocalized": slam.n_relocalized, "resets": slam.n_resets, "ate_m": ate, "wall_s": wall,
            "fps": n / wall, "track_ms_p50": st["track_ms_p50"], "track_ms_p90": st["track_ms_p90"],
            "map_ms_p50": st["map_ms_p50"], "host_syncs": syncs, "host_syncs_per_frame": syncs / n,
            "launches": launches, "stats": st, "card": card, **extra}


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
    CPU on exact correspondences with 20% outliers, the same hypothesis sets:
    the same inlier set and count, poses within 1e-4."""
    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch.ops import pnp

    rng = np.random.default_rng(4)
    n = 1000
    pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 6, n)], -1)
    uv = np.stack([550 * pc[:, 0] / pc[:, 2] + 320, 550 * pc[:, 1] / pc[:, 2] + 240], -1)
    uv[::5] = rng.uniform([0, 0], [640, 480], (n // 5, 2))
    args = [torch.from_numpy(a.astype(np.float32)) for a in (pc, uv, np.ones(n))] + [torch.ones(n, dtype=torch.bool)]
    K = torch.tensor([550.0, 550.0, 320.0, 240.0])
    sets = pnp.sample_sets(args[3], torch.Generator().manual_seed(1))
    ref = pnp.pnp_ransac(*args, K, sets=sets)
    got = pnp.pnp_ransac(*(a.to(dev) for a in args), K.to(dev), sets=sets.to(dev))
    same = torch.equal(got.inliers.cpu(), ref.inliers)
    dT = float((got.Tcw.cpu() - ref.Tcw).abs().max())
    log(f"PnP RANSAC (256 x 12x12 float64 eigh, 1000 points): card {int(got.n_inliers)} inliers, CPU "
        f"{int(ref.n_inliers)}, same inlier set {same}, pose difference {dT:.2e}")
    if not (same and int(got.n_inliers) == int(ref.n_inliers) and dT <= 1e-4):
        raise AssertionError("PnP RANSAC on the card disagrees with the CPU")
    return {"inliers": int(got.n_inliers), "same_inlier_set": same, "max_pose_diff": dT}


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
    rec = online_record(slam, outs, wall, launches, syncs, ate, card, ate_bound_m=ONLINE_ATE_BOUND,
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


def run_stereo(name, cfg, n, step, ate_bound, min_tracked, card, cpu_check=False):
    """Phases 7 and 8: a dolly through SlamSystem.track_stereo on the card."""
    import numpy as np
    import torch
    from orb_slam2v2_1_tpu_torch.models import frontend
    from orb_slam2v2_1_tpu_torch.models.system import Sensor, SlamSystem
    from orb_slam2v2_1_tpu_torch.ops import orb
    from orb_slam2v2_1_tpu_torch.utils import synthetic

    left, right, gt = synthetic.stereo_dolly_frames(cfg, range(n), np.random.default_rng(3), dx=step[0], dz=step[1])
    slam = SlamSystem(config=cfg, sensor=Sensor.STEREO)
    outs, _, wall, launches, syncs = drive(slam, list(zip(left, right)), slam.track_stereo)
    ate = ate_of(slam, {j * 0.1: T for j, T in enumerate(gt)})
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
    rec = online_record(slam, outs, wall, launches, syncs, ate, card, **extra)
    rec["untracked_frames"] = [j for j, o in enumerate(outs) if o is None]
    log(f"{name}: {rec['tracked']}/{n} tracked (lost: {rec['untracked_frames']}), {slam.n_kf_host} keyframes, "
        f"{rec['map_points']} points, "
        f"ATE {ate:.4f} m (bound {ate_bound:.4f}), track ms p50 {rec['track_ms_p50']:.1f} p90 "
        f"{rec['track_ms_p90']:.1f}, {rec['fps']:.2f} frames/s, host syncs {syncs / n:.1f}/frame, "
        f"launches {launches}, {card}")
    if rec["tracked"] < min_tracked:
        raise AssertionError(f"{name}: tracked {rec['tracked']}/{n} < {min_tracked}")
    if not ate <= ate_bound:
        raise AssertionError(f"{name}: ATE {ate:.4f} m > {ate_bound:.4f} m")
    if launches["fast_score_nms"] != 2 * n:
        raise AssertionError(f"{name}: fast_score_nms {launches['fast_score_nms']} launches for {n} stereo frames")
    return rec, launches


def run_desk(name, cfg, sensor, poses, ate_bound, card):
    """Phases 9 and 10: an evaluate.py desk leg through SlamSystem on the
    card, counted as evaluate.py's run_sequence counts it."""
    from orb_slam2v2_1_tpu_torch.models.system import Sensor, SlamSystem
    from orb_slam2v2_1_tpu_torch.utils import synthetic

    mono = sensor == Sensor.MONOCULAR
    imgs, deps, gt = synthetic.desk_frames(cfg, poses)  # no device given: the card
    slam = SlamSystem(config=cfg, sensor=sensor)
    if mono:
        outs, _, wall, launches, syncs = drive(slam, [(img, None) for img in imgs],
                                               lambda a, b, ts: slam.track_monocular(a, ts))
    else:
        outs, _, wall, launches, syncs = drive(slam, list(zip(imgs, deps)), slam.track_rgbd)
    n = len(outs)
    ate = ate_of(slam, {j * 0.1: T for j, T in enumerate(gt)}, align_scale=mono)
    entries = slam.trajectory.entries
    tracked = sum(not e.lost for e in entries)
    first = next((k for k, e in enumerate(entries) if not e.lost), None)
    post_init = tracked / max(len(entries) - first, 1) if first is not None else 0.0
    rec = online_record(slam, outs, wall, launches, syncs, ate, card, ate_bound_m=ate_bound, tracked=tracked,
                        tracked_share=tracked / n, tracked_share_post_init=post_init,
                        first_pose_frame=next((j for j, o in enumerate(outs) if o is not None), None),
                        scale_aligned=mono)
    log(f"{name}: {tracked}/{n} tracked (post-init share {post_init:.3f}, first pose at frame "
        f"{rec['first_pose_frame']}), {slam.n_kf_host} keyframes, {slam.n_relocalized} relocalizations, "
        f"{slam.n_resets} resets, {rec['map_points']} points, ATE {ate:.5f} m{' scale-aligned' if mono else ''} "
        f"(bound {ate_bound:.5f}), track ms p50 {rec['track_ms_p50']:.1f} p90 {rec['track_ms_p90']:.1f}, "
        f"{rec['fps']:.2f} frames/s, host syncs {syncs / n:.1f}/frame, launches {launches}, {card}")
    if not ate <= ate_bound:
        raise AssertionError(f"{name}: ATE {ate:.5f} m > {ate_bound:.5f} m")
    if launches["fast_score_nms"] != n:
        raise AssertionError(f"{name}: fast_score_nms {launches['fast_score_nms']} launches for {n} frames")
    for kernel, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {kernel} was not launched by the {name} path")
    return rec, launches


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
    from orb_slam2v2_1_tpu_torch import kernel_times as kt
    from orb_slam2v2_1_tpu_torch import kernels, sync
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

    # --- the same frames through the plain versions on the CPU ---
    cpu_poses, cpu_ok, _ = offline.track_sequence_rgbd(
        imgs[:CPU_CHECK_FRAMES].cpu().numpy(), deps[:CPU_CHECK_FRAMES].cpu().numpy(), cfg, device="cpu")
    dc = np.linalg.norm(centers(cpu_poses) - c_est[:CPU_CHECK_FRAMES], axis=1).max()
    log(f"CPU plain path, frames 0-{CPU_CHECK_FRAMES - 1}: ok {cpu_ok.tolist()}, max center diff {dc:.2e} m")
    if not (np.array_equal(cpu_ok, ok[:CPU_CHECK_FRAMES]) and dc <= 2e-3):
        raise AssertionError("the card's path disagrees with the CPU plain path")

    # --- the loop path ---
    loop_rec, loop_launches, loop_poses, loop_ok = run_loop_path(all_imgs, all_deps, all_gt, cfg, dev, card)

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

    def entry(name, res, src, line):
        return {"name": name, "route": "cuda", "source": f"orb_slam2v2_1_tpu_torch/csrc/{src}",
                "replaces": f"orb_slam2v2_1_tpu/ops/pallas_kernels.py:{line}", "launches": loop_launches[name],
                "launches_by_path": {"rgbd_96_frames": launches[name], "loop_321_frames": loop_launches[name],
                                     "online_rgbd": online_launches[name], "stereo_dolly": dolly_launches[name],
                                     "stereo_kitti": kitti_launches[name], "clean_desk_rgbd": desk_launches[name],
                                     "clean_mono": mono_launches[name]},
                "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": None,
                "wrapper_ms": res["wrapper_ms"], "empty_launch_ms": floor_ms, "shapes": res["shapes"]}

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({
        "kernels": [entry("fast_score_nms", fast_res, "fast_score_nms.cu", 137),
                    entry("masked_best_two", match_res, "masked_best_two.cu", 225)],
        "main_path": {"frames": N_FRAMES, "tracked": n_ok, "keyframes": n_kf, "map_points": n_mp,
                      "ate_m": ate, "ate_anchored_m": ate_anchored, "wall_s": wall,
                      "fps": N_FRAMES / wall, "host_syncs": syncs, "card": card},
        "loop_path": loop_rec,
        "online_rgbd": online_rec,
        "stereo_dolly": dolly_rec,
        "stereo_kitti": kitti_rec,
        "clean_desk_rgbd": desk_rec,
        "clean_mono": mono_rec,
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
    from orb_slam2v2_1_tpu_torch import sync
    from orb_slam2v2_1_tpu_torch.models import loop_closing, offline

    closer = make_loop_closer(cfg, dev)
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
