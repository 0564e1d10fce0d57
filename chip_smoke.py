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
     noise), (idx, best, second) and the finished one-to-one match at the
     five search shapes (motion model, local map, batched fuse, and loop
     closing's Sim3 search and loop fusion). Per form: the device time
     without the host (100 calls in one CUDA graph between two events), the
     wrapper-included time and the plain version's (events around one call,
     median of 20), the bound reckoned from this run's inputs, and the empty
     kernel's launch;
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
     often than frames were tracked, no global-BA thread left running.
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


def check_fast(kt, img, noise, cfg, ocfg, floor_ms):
    """Kernel 1, both forms, exact: the score map per level, and cell_best /
    cell_arg for the whole pyramid on the rendered frame and on noise."""
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
        shapes.append(timed(kt, "fast_score_nms map", list(lvl.shape), lambda: kernels.fast_score_nms(lvl),
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
        log(f"fast_score_nms cells, {name} frame: equal over {len(lv)} levels, {n_cells} cells, "
            f"{n_strong} with a strong corner, {n_empty} empty")
    pixels = sum(lvl.numel() for lvl in levels)
    cells = sum(ch * cw for ch, cw in got.grids)
    main = timed(kt, "fast_score_nms cells", [list(lvl.shape) for lvl in levels],
                 lambda: fast.suppressed_cells_pyramid(levels, **rank), lambda: plain_cells(levels),
                 4 * pixels + 12 * cells, FAST_OPS_PER_PIXEL * pixels, floor_ms)
    return {"max_abs_err": 0.0, **{k: main[k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")},
            "shapes": shapes + [main]}


def check_match(kt, dev, rng, floor_ms):
    """Kernel 2, both forms, exact, at the five shapes of the two paths."""
    import torch
    from orb_slam2v2_1_tpu_torch.ops import matching

    shapes = []
    for name, (b, q, n) in kt.SEARCH_SHAPES:
        qf, r, tf = kt.search_inputs(rng, dev, b, q, n)
        max_dist, ratio = kt.SEARCH_PARAMS[name]
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

    t0 = time.perf_counter()
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
                "launches_by_path": {"rgbd_96_frames": launches[name], "loop_321_frames": loop_launches[name]},
                "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": None,
                "wrapper_ms": res["wrapper_ms"], "empty_launch_ms": floor_ms, "shapes": res["shapes"]}

    print(json.dumps({
        "kernels": [entry("fast_score_nms", fast_res, "fast_score_nms.cu", 137),
                    entry("masked_best_two", match_res, "masked_best_two.cu", 225)],
        "main_path": {"frames": N_FRAMES, "tracked": n_ok, "keyframes": n_kf, "map_points": n_mp,
                      "ate_m": ate, "ate_anchored_m": ate_anchored, "wall_s": wall,
                      "fps": N_FRAMES / wall, "host_syncs": syncs, "card": card},
        "loop_path": loop_rec,
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
