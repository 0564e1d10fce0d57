#!/usr/bin/env python3
"""ATE of the JAX reference package on the benchmark's RGB-D orbit, on the CPU.

    python3 tests/torch_reference_orbit.py [--frames 321] [--no-loop] [--out FILE]
    python3 tests/torch_reference_orbit.py --compare-small
    python3 tests/torch_reference_orbit.py --sensitivity
    python3 tests/torch_reference_orbit.py --online [--stereo] [--out FILE]
    python3 tests/torch_reference_orbit.py --stereo [--out FILE]
    python3 tests/torch_reference_orbit.py --desk [--out FILE]

The number that `chip_smoke.py` holds the PyTorch port's loop path to: the
same orbit (the room, seed and poses of `bench.orbit_frames`), the same
configuration and the same loop closer (`bench.make_loop_closer`: shared
vocabulary, detached global BA, `chunk=32`) through `orb_slam2v2_1_tpu.models.offline.track_sequence_rgbd`,
with JAX on the CPU (its Pallas kernels run through their references there).
The ATE is the rigid-aligned RMS of the camera centers of the tracked frames
against the orbit's ground truth, as `chip_smoke.py` computes it. Not a test:
pytest does not collect this file. It takes minutes at 321 frames.

`--compare-small` puts the 321 frames at 320x240 (500 features, 64 keyframes,
8192 map points) through both packages on the CPU, each with its loop closer
and its own RANSAC draws, and prints each package's closures and how far the
two trajectories drift apart. `--sensitivity` gives that drift its scale: the
reference alone, on the first 200 of those frames without a loop closer,
against itself on the same frames with uniform noise of +-0.001 gray levels
(of 255) added.

`--online` and `--stereo` run the reference's online entry point,
`SlamSystem` in sync mode, on exactly the frames of `chip_smoke.py`'s
phases 6-8 (its ONLINE_SEQUENCE, the stereo dolly of `evaluate.py` and the
KITTI geometry of `bench.py`): tracked frames, keyframes, relocalizations and
the ATE (`utils.trajectory.ate_rmse` without scale). Twice these ATEs are
`chip_smoke.py`'s bounds for the port.

`--desk` runs the reference's `SlamSystem` on the frames of `chip_smoke.py`'s
phases 9 and 10, `evaluate.py`'s clean_desk_rgbd and clean_mono (rendered by
the port's renderer on the CPU), counted as `evaluate.py run_sequence`
counts them: tracked frames, the post-initialization tracked share,
keyframes, resets, and the ATE (rigid for RGB-D, scale-aligned for mono).
The tracked counts are the floors of `chip_smoke.py`'s gates there.
"""

import json
import os
import sys
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
from orb_slam2v2_1_tpu.models import offline  # noqa: E402
from orb_slam2v2_1_tpu.ops import lie  # noqa: E402
from orb_slam2v2_1_tpu.utils.config import SlamConfig  # noqa: E402

BENCH = dict(fx=550.0, fy=550.0, cx=320.0, cy=240.0, width=640, height=480, n_features=1000,
             max_keyframes=128, max_map_points=16384, fps=10.0, bf=44.0, th_depth=100.0)
TOTAL = 321  # the orbit's pose k depends on the total: two turns over 321 frames


def orbit_poses(n_frames):
    """World->camera poses of the first `n_frames` of `bench.orbit_frames`."""
    poses = []
    for k in range(n_frames):
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, :3] = np.asarray(lie.so3_exp(jnp.asarray([0.0, 2.0 * 2 * np.pi * k / TOTAL, 0.0], jnp.float32)))
        Twc[:3, 3] = [0.0, 0.0, 3.0]
        poses.append(np.linalg.inv(Twc).astype(np.float32))
    return np.stack(poses)


def render_orbit(cfg, poses):
    """The frames of `bench.orbit_frames` at the given poses (its room, its
    seed, its renderer)."""
    from orb_slam2v2_1_tpu.utils import synthetic

    room = synthetic.make_room(np.random.default_rng(11))
    scene = synthetic.PlaneScene(room.origin[:6], room.ux[:6], room.vy[:6], room.tex[:6])
    K = jnp.asarray(cfg.K)
    frames = [synthetic.render(scene, jnp.asarray(Tcw), K, cfg.width, cfg.height) for Tcw in poses]
    return np.stack([np.asarray(i) for i, _ in frames]), np.stack([np.asarray(d) for _, d in frames])


def centers(poses):
    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])


def ate_rigid(est, gt):
    """RMS position error after a rigid Horn alignment (no scale)."""
    P, Q = est.T.astype(np.float64), gt.T.astype(np.float64)
    mu_p, mu_q = P.mean(1, keepdims=True), Q.mean(1, keepdims=True)
    U, _, Vt = np.linalg.svd((Q - mu_q) @ (P - mu_p).T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    err = R @ P + (mu_q - R @ mu_p) - Q
    return float(np.sqrt((err * err).sum(0).mean()))


SMALL = dict(BENCH, fx=275.0, fy=275.0, cx=160.0, cy=120.0, width=320, height=240, n_features=500,
             max_keyframes=64, max_map_points=8192)


def sensitivity(n_frames=200, amplitude=1e-3):
    cfg = SlamConfig(**SMALL)
    imgs, deps = render_orbit(cfg, orbit_poses(n_frames))
    noisy = (imgs + np.random.default_rng(0).uniform(-amplitude, amplitude, imgs.shape)).astype(np.float32)
    poses, _, state = offline.track_sequence_rgbd(imgs, deps, cfg)
    poses_n, _, state_n = offline.track_sequence_rgbd(noisy, deps, cfg)
    apart = np.linalg.norm(centers(np.asarray(poses)) - centers(np.asarray(poses_n)), axis=1)
    print(json.dumps({
        "package": "orb_slam2v2_1_tpu (JAX, CPU)", "frames": n_frames, "gray_noise": amplitude,
        "keyframes": [int(np.asarray(state.kf_valid).sum()), int(np.asarray(state_n.kf_valid).sum())],
        "centers_apart_m_every_16_frames": [round(float(x), 4) for x in apart[::16]],
    }), flush=True)


def compare_small():
    import torch
    from orb_slam2v2_1_tpu.models import keyframe_database as jkdb
    from orb_slam2v2_1_tpu.models import loop_closing as jlc
    from orb_slam2v2_1_tpu.ops import vocab as jvocab
    from orb_slam2v2_1_tpu_torch.models import keyframe_database as kdb
    from orb_slam2v2_1_tpu_torch.models import loop_closing as lc
    from orb_slam2v2_1_tpu_torch.models import offline as toffline
    from orb_slam2v2_1_tpu_torch.ops import vocab
    from orb_slam2v2_1_tpu_torch.utils import config as tconfig

    kw = SMALL
    cfg = SlamConfig(**kw)
    imgs, deps = render_orbit(cfg, orbit_poses(TOTAL))
    npz = np.load(jvocab.__file__.replace("ops/vocab.py", "data/vocab.npz"))
    tcl = lc.LoopCloser(vocab.load_vocabulary(npz, device="cpu"), kdb.empty_database(64, 500, 10000, device="cpu"),
                        True, torch.tensor(cfg.K), cfg.bf)
    jcl = jlc.LoopCloser(jvocab.load_vocabulary(npz), jkdb.empty_database(64, 500, 10000), True,
                         jnp.asarray(cfg.K), jnp.float32(cfg.bf))
    jclosures = []
    apply_closure = jcl.apply_closure

    def logged_closure(state, kf_id, cand, S12):
        state = apply_closure(state, kf_id, cand, S12)
        jclosures.append((jcl.kf_counter, int(kf_id), int(cand)))
        return state

    jcl.apply_closure = logged_closure
    for closer in (tcl, jcl):
        closer.enable_detached_gba()
    tposes, tok, tstate = toffline.track_sequence_rgbd(imgs, deps, tconfig.SlamConfig(**kw), loop_closer=tcl, chunk=32,
                                                       device="cpu")
    jposes, jok, jstate = offline.track_sequence_rgbd(imgs, deps, cfg, loop_closer=jcl, chunk=32)
    apart = np.linalg.norm(centers(tposes) - centers(np.asarray(jposes)), axis=1)
    print(json.dumps({
        "port": {"tracked": int(tok.sum()), "keyframes": int(tstate.kf_valid.sum()), "closures": tcl.closures,
                 "detect_suppressed": tcl.n_detect_suppressed},
        "reference": {"tracked": int(np.asarray(jok).sum()), "keyframes": int(np.asarray(jstate.kf_valid).sum()),
                      "closures": jclosures, "detect_suppressed": jcl.n_detect_suppressed},
        "centers_apart_m_every_32_frames": [round(float(x), 4) for x in apart[::32]],
    }), flush=True)


def _slam_ate(slam, gt_Tcw):
    from orb_slam2v2_1_tpu.utils.trajectory import ate_rmse

    est = slam.trajectory.absolute_poses(np.asarray(slam.map.kf_pose))
    return ate_rmse(est, {t: np.linalg.inv(T) for t, T in gt_Tcw.items()}, align_scale=False)


def online():
    """chip_smoke.py phase 6 on the reference: the orbit with a blackout and
    a far replay through SlamSystem.track_rgbd."""
    import chip_smoke
    from orb_slam2v2_1_tpu.models import relocalization
    from orb_slam2v2_1_tpu.models.system import Sensor, SlamSystem

    cfg = SlamConfig(**BENCH)
    gt = orbit_poses(96)
    imgs, deps = render_orbit(cfg, gt)
    relocs = []
    real = relocalization.relocalize

    def counted(*a, **k):
        out = real(*a, **k)
        relocs.append(bool(out[0]))
        return out

    relocalization.relocalize = counted
    slam = SlamSystem(config=cfg, sensor=Sensor.RGBD)
    black = np.zeros_like(imgs[0])
    outs, states, kf_before = [], [], None
    t0 = time.time()
    for j, k in enumerate(chip_smoke.ONLINE_SEQUENCE):
        if j == chip_smoke.BLACKOUT.start:
            kf_before = slam.n_kf_host
        outs.append(slam.track_rgbd(black if k is None else imgs[k], black if k is None else deps[k], j * 0.1))
        states.append(slam.state.name)
    wall = time.time() - t0
    relocalization.relocalize = real
    g0 = np.linalg.inv(gt[0])
    ate = _slam_ate(slam, {j * 0.1: gt[k] @ g0 for j, k in enumerate(chip_smoke.ONLINE_SEQUENCE) if k is not None})
    seen = [o for o, k in zip(outs, chip_smoke.ONLINE_SEQUENCE) if k is not None]
    return {"path": "online_rgbd", "package": "orb_slam2v2_1_tpu (JAX, CPU)", "frames": len(outs),
            "returned_pose": sum(o is not None for o in outs), "tracked_share": sum(o is not None for o in seen) / len(seen),
            "keyframes_before_blackout": kf_before, "black_states": states[chip_smoke.BLACKOUT],
            "replay_returned": [o is not None for o in outs[chip_smoke.REPLAY:chip_smoke.REPLAY + 2]],
            "far_returned": [o is not None for o in outs[chip_smoke.FAR]], "relocalized": sum(relocs),
            "resets": slam.n_resets, "keyframes": slam.n_kf_host, "loops_closed": slam.n_loops_closed,
            "ate_m": ate, "wall_s": wall, "stats": slam.stats()}


def stereo():
    """chip_smoke.py phases 7 and 8 on the reference: the stereo dolly and the
    KITTI geometry through SlamSystem.track_stereo."""
    import chip_smoke
    from orb_slam2v2_1_tpu.models.system import Sensor, SlamSystem
    from orb_slam2v2_1_tpu.utils import synthetic
    from orb_slam2v2_1_tpu_torch.kernel_times import KITTI

    out = []
    for name, kw, n, (dx, dz) in (("stereo_dolly", BENCH, chip_smoke.DOLLY_FRAMES, chip_smoke.DOLLY_STEP),
                                  ("stereo_kitti", KITTI, chip_smoke.KITTI_FRAMES, chip_smoke.KITTI_STEP)):
        cfg = SlamConfig(**kw)
        room = synthetic.make_room(np.random.default_rng(3))
        K = jnp.asarray(cfg.K)
        slam = SlamSystem(config=cfg, sensor=Sensor.STEREO)
        gt, n_ok = {}, 0
        t0 = time.time()
        for i in range(n):
            Tcw = np.eye(4, dtype=np.float32)
            Tcw[0, 3], Tcw[2, 3] = -dx * i, -dz * i
            Tr = Tcw.copy()
            Tr[0, 3] -= cfg.bf / cfg.fx
            il, _ = synthetic.render(room, jnp.asarray(Tcw), K, cfg.width, cfg.height)
            ir, _ = synthetic.render(room, jnp.asarray(Tr), K, cfg.width, cfg.height)
            n_ok += slam.track_stereo(il, ir, i * 0.1) is not None
            gt[i * 0.1] = Tcw
        out.append({"path": name, "package": "orb_slam2v2_1_tpu (JAX, CPU)", "frames": n, "tracked": n_ok,
                    "keyframes": slam.n_kf_host, "ate_m": _slam_ate(slam, gt), "wall_s": time.time() - t0})
    return out


def desk():
    """chip_smoke.py phases 9 and 10 on the reference."""
    import chip_smoke
    from orb_slam2v2_1_tpu.models.system import Sensor, SlamSystem
    from orb_slam2v2_1_tpu.utils.trajectory import ate_rmse
    from orb_slam2v2_1_tpu_torch.kernel_times import EVAL
    from orb_slam2v2_1_tpu_torch.utils import config as tconfig
    from orb_slam2v2_1_tpu_torch.utils import synthetic as tsyn

    out = []
    for name, sensor, poses, bf in (
            ("clean_desk_rgbd", Sensor.RGBD, tsyn.desk_trajectory(chip_smoke.DESK_FRAMES), EVAL["bf"]),
            ("clean_mono", Sensor.MONOCULAR, tsyn.lateral_trajectory(chip_smoke.MONO_FRAMES), 0.0)):
        kw = dict(EVAL, bf=bf)
        imgs, deps, gt = tsyn.desk_frames(tconfig.SlamConfig(**kw), poses, device="cpu")
        imgs, deps = imgs.numpy(), deps.numpy()
        slam = SlamSystem(config=SlamConfig(**kw), sensor=sensor)
        t0 = time.time()
        for i in range(len(imgs)):
            if sensor == Sensor.MONOCULAR:
                slam.track_monocular(imgs[i], i * 0.1)
            else:
                slam.track_rgbd(imgs[i], deps[i], i * 0.1)
        wall = time.time() - t0
        entries = slam.trajectory.entries
        tracked = sum(not e.lost for e in entries)
        first = next((k for k, e in enumerate(entries) if not e.lost), None)
        est = slam.trajectory.absolute_poses(np.asarray(slam.map.kf_pose))
        ate = ate_rmse(est, {i * 0.1: np.linalg.inv(T) for i, T in enumerate(gt)},
                       align_scale=sensor == Sensor.MONOCULAR)
        out.append({"path": name, "package": "orb_slam2v2_1_tpu (JAX, CPU)", "frames": len(imgs), "tracked": tracked,
                    "tracked_share_post_init": tracked / max(len(entries) - first, 1) if first is not None else 0.0,
                    "first_tracked_time": None if first is None else entries[first].timestamp,
                    "keyframes": slam.n_kf_host, "resets": slam.n_resets, "loops_closed": slam.n_loops_closed,
                    "ate_m": ate, "scale_aligned": sensor == Sensor.MONOCULAR, "wall_s": wall})
    return out


def main():
    args = sys.argv[1:]
    if args == ["--compare-small"]:
        return compare_small()
    if args == ["--sensitivity"]:
        return sensitivity()
    if args and args[0] in ("--online", "--stereo", "--desk"):
        if not set(args) - {"--online", "--stereo", "--desk", "--out"} <= ({args[-1]} if "--out" in args else set()):
            raise SystemExit(__doc__)
        out = args[args.index("--out") + 1] if "--out" in args else None
        records = (([online()] if "--online" in args else []) + (stereo() if "--stereo" in args else [])
                   + (desk() if "--desk" in args else []))
        for record in records:
            print(json.dumps(record, default=str), flush=True)
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            with open(out, "w") as f:
                json.dump(records, f, indent=1, default=str)
        return None
    n_frames, with_loop, out = 321, True, None
    while args:
        if args[0] == "--frames":
            n_frames, args = int(args[1]), args[2:]
        elif args[0] == "--out":
            out, args = args[1], args[2:]
        elif args[0] == "--no-loop":
            with_loop, args = False, args[1:]
        else:
            raise SystemExit(__doc__)
    cfg = SlamConfig(**BENCH)
    t0 = time.time()
    gt = orbit_poses(n_frames)
    imgs, deps = render_orbit(cfg, gt)
    print(f"rendered {n_frames} frames in {time.time() - t0:.1f} s", flush=True)
    closer = bench.make_loop_closer(cfg, jnp.asarray(cfg.K), jnp.float32(cfg.bf)) if with_loop else None
    closures = []  # (insertion count, keyframe, loop keyframe) of each closure
    if closer is not None:
        apply_closure = closer.apply_closure

        def logged_closure(state, kf_id, cand, S12):
            state = apply_closure(state, kf_id, cand, S12)
            closures.append((closer.kf_counter, int(kf_id), int(cand)))
            return state

        closer.apply_closure = logged_closure
    t0 = time.time()
    poses, ok, state = offline.track_sequence_rgbd(imgs, deps, cfg, loop_closer=closer,
                                                   chunk=32 if with_loop else None)
    wall = time.time() - t0
    poses, ok = np.asarray(poses), np.asarray(ok).astype(bool)
    gt = np.stack([g @ np.linalg.inv(gt[0]) for g in gt])  # world = first camera
    record = {
        "package": "orb_slam2v2_1_tpu (JAX, CPU)", "frames": n_frames, "loop_closer": with_loop,
        "tracked": int(ok.sum()), "keyframes": int(np.asarray(state.kf_valid).sum()),
        "map_points": int(np.asarray(state.mp_valid).sum()),
        "ate_m": ate_rigid(centers(poses)[ok], centers(gt)[ok]), "wall_s": wall,
    }
    if closer is not None:
        r = closer.gba_runner
        record.update(loops_closed=closer.n_loops_closed, closures=closures, detect_suppressed=closer.n_detect_suppressed,
                      gba_runs=r.n_runs, gba_merged=closer.n_gba_merged, gba_aborted=r.n_aborted)
    print(json.dumps(record), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
