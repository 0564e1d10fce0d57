"""The correctness check: what the timed path produced, against the plain
reference, number by number against the cell's limits.

Run once the window has closed, the device peak has been read and the
system has been shut down. Judged are the program's outputs only:

- `unanswered`: frames submitted in the window whose pose was never
  published, once the system has decided every frame in flight (limit 0).
  A monocular session's frames before its first pose are its two-view
  initializer's: the program answers them by returning from the call with
  no pose, as ORB-SLAM2's `TrackMonocular` does, and publishes nothing. A
  monocular session that published no pose never initialized, and every
  frame of it counts, except in the window's last session, which the
  window's close may have cut before it initialized. How long a session may
  take to its first pose is a cell's own compared number (a file of
  `checks/`).
- `ate_m`: the published poses. Each session's camera centres are
  rigidly aligned onto the true ones (Umeyama), or, where the sensor leaves
  the scale free (monocular), aligned by a similarity, as the TUM
  benchmark's `evaluate_ate` does for monocular runs; the RMS of the errors
  over every published pose of every session with 3 or more.
- `rot_rmse_deg`: the published orientations, each session's taken relative
  to its first published pose, against the truth's; RMS in degrees.
- `map_point_m`: the maps that the sessions left (local mapping, loop
  closing and the global BA included). Each point observed by a keypoint of
  a live keyframe is put in that keyframe's camera frame by the keyframe's
  pose; the reference back-projects the keypoint at the true depth that the
  reference renderer gives there. The median gap in metres. A monocular
  keyframe's points are first multiplied by its session's scale from the
  `ate_m` alignment; a session with fewer than 3 published poses has none,
  and its keyframes are left out.
- `orb_keypoints_differ`, `orb_bits_differ`: the ORB features of keyframes
  (frames the timed path built: FAST scores, suppression and cells from the
  `fast_score_nms` kernel, the descriptors after it), a sample drawn from
  the seed, against the plain ORB on the same image. The share of keypoint
  slots whose validity, level or position differs, and the share of
  descriptor bits that differ among the slots that agree.

A limit that names none of these is the number of the harness's file
`checks/<name>.py` (see `judge`). It imports nothing of the program.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from . import sensors
from .reference import orb as orb_ref
from .reference import trajectory as traj_ref

ORB_SAMPLE = 24  # keyframes whose features are recomputed by the reference
XY_TOL = 0.01  # px: undistortion without distortion moves a keypoint by float32 rounding only
# The numbers this file computes; a limit of another name is a file of `checks/`.
NUMBERS = ("unanswered", "ate_m", "rot_rmse_deg", "map_point_m", "orb_keypoints_differ", "orb_bits_differ")


def _unpack(words: np.ndarray) -> np.ndarray:
    """(..., 8) int32 descriptor words -> (..., 256) bool, bit b of word w = bit 32w+b."""
    w = words.astype(np.int64) & 0xFFFFFFFF
    return ((w[..., :, None] >> np.arange(32)) & 1).astype(bool).reshape(*words.shape[:-1], 256)


def pose_numbers(win, sess, sensor: str, scales: dict | None = None) -> dict:
    """`unanswered`, `ate_m`, `rot_rmse_deg` of the published poses.
    `scales`, where given, receives the similarity's scale of each session
    of a sensor that leaves the scale free."""
    metric = sensors.SENSORS[sensor].metric
    unanswered = [key for key in win.submitted if key not in win.published]
    pos_err, rot_err = [], []
    for s in range(win.session + 1):
        ks = sorted(k for (ss, k), (_, T) in win.published.items() if ss == s and T is not None)
        if len(ks) < 3:
            continue
        est = np.stack([win.published[(s, k)][1] for k in ks])
        gt = sess.gt[np.asarray(ks) % len(sess.gt)]
        est_c, gt_c = traj_ref.centers(est), traj_ref.centers(gt)
        alignment = traj_ref.umeyama(est_c, gt_c, with_scale=not metric)
        pos_err.append(traj_ref.residuals(est_c, gt_c, *alignment))
        if scales is not None:
            scales[s] = alignment[0]
        rot_err.append(traj_ref.rotation_errors_deg(est, gt))
    if not metric:
        first = win.first_pose()
        unanswered = [(s, k) for s, k in unanswered if (k > first[s] if s in first else s < win.session)]
    unanswered = len(unanswered)
    if not pos_err:
        return {"unanswered": float(unanswered), "ate_m": float("inf"), "rot_rmse_deg": float("inf")}
    pe, re = np.concatenate(pos_err), np.concatenate(rot_err)
    finite = np.isfinite(pe).all() and np.isfinite(re).all()
    return {
        "unanswered": float(unanswered),
        "ate_m": float(np.sqrt(np.mean(pe**2))) if finite else float("inf"),
        "rot_rmse_deg": float(np.sqrt(np.mean(re**2))) if finite else float("inf"),
    }


def _keyframes(win, maps):
    """(session, slot, frame k, host arrays of the map) of every live keyframe
    whose frame is known."""
    out = []
    for s, m in enumerate(maps):
        host = {f: t.detach().cpu().numpy() for f, t in m.items()}
        for slot in np.flatnonzero(host["kf_valid"]):
            k = win.frame_of_id[s].get(int(host["kf_frame_id"][slot]))
            if k is not None:
                out.append((s, int(slot), k, host))
    return out


def map_number(kfs, sess, K, by_session: dict | None = None, scales: dict | None = None) -> float:
    """`map_point_m`: the median gap between each observed point in its
    keyframe's camera and the reference's back-projection of the keypoint.
    `by_session`, where given, receives each session's own median (logged,
    not compared). `scales`, where given (a sensor that leaves the scale
    free), multiplies each session's points by its scale and leaves out the
    keyframes of a session that has none."""
    gaps, session_of = [], []
    depth_cache = {}
    for s, slot, k, m in kfs:
        if scales is not None and s not in scales:
            continue
        mp = m["kf_mp"][slot]
        obs = np.flatnonzero(m["kf_kp_valid"][slot] & (mp >= 0))
        obs = obs[m["mp_valid"][mp[obs]]]
        if len(obs) == 0:
            continue
        ids = mp[obs]
        T = m["kf_pose"][slot].astype(np.float64)
        Xc = m["mp_pos"][ids].astype(np.float64) @ T[:3, :3].T + T[:3, 3]
        if scales is not None:
            Xc = Xc * scales[s]
        k %= len(sess.gt)
        if k not in depth_cache:
            depth_cache[k] = sess.depth[k].detach().cpu().numpy().astype(np.float64)
        xy = m["kf_xy"][slot][obs].astype(np.float64)
        d = traj_ref.sample_depth(depth_cache[k], xy)
        seen = d > 0
        ref = traj_ref.back_project(xy[seen], d[seen], K)
        gaps.append(np.linalg.norm(Xc[seen] - ref, axis=1))
        session_of.append(np.full(len(gaps[-1]), s))
    if not gaps:
        return float("inf")
    g = np.concatenate(gaps)
    if by_session is not None:
        of = np.concatenate(session_of)
        by_session.update({int(s): float(np.median(g[of == s])) for s in np.unique(of)})
    return float(np.median(g)) if len(g) and np.isfinite(g).all() else float("inf")


def orb_numbers(kfs, sess, cfg: dict, rng: np.random.Generator) -> dict:
    """`orb_keypoints_differ` and `orb_bits_differ` over a seeded sample of
    keyframes."""
    if not kfs:
        return {"orb_keypoints_differ": float("inf"), "orb_bits_differ": float("inf")}
    pick = rng.choice(len(kfs), size=min(ORB_SAMPLE, len(kfs)), replace=False)
    slots = slots_differ = bits = bits_differ = 0
    for i in sorted(pick):
        _, slot, k, m = kfs[i]
        with torch.no_grad():
            ref = orb_ref.extract(sess.first[k % len(sess.gt)], cfg["n_features"], cfg["n_levels"], cfg["scale_factor"],
                                  cfg["fast_threshold"], cfg["fast_min_threshold"])
        r_xy, r_lv, r_ok, r_bits = (t.cpu().numpy() for t in ref)
        p_xy, p_lv, p_ok = m["kf_xy"][slot], m["kf_level"][slot], m["kf_kp_valid"][slot]
        if len(p_ok) != len(r_ok):
            slots += max(len(p_ok), len(r_ok))
            slots_differ += max(len(p_ok), len(r_ok))
            continue
        p_bits = _unpack(m["kf_desc"][slot])
        same = (r_ok == p_ok) & (~r_ok | ((r_lv == p_lv) & (np.abs(r_xy - p_xy).max(1) <= XY_TOL)))
        slots += len(p_ok)
        slots_differ += int((~same).sum())
        both = same & r_ok
        bits += 256 * int(both.sum())
        bits_differ += int((r_bits[both] != p_bits[both]).sum())
    return {"orb_keypoints_differ": slots_differ / max(slots, 1),
            "orb_bits_differ": bits_differ / bits if bits else float("inf")}


def judge(win, maps, sess, config: dict, limits: dict, seed: int, checks: dict | None = None):
    """(correct, [(name, value, limit)], every number) of one run of the
    configuration `config` (its file: `sensor` and `slam`): the numbers that
    the cell's limits name are compared. A limit's name that this file does
    not compute (`NUMBERS`) is the number that `checks[name]` (`number(ctx)`
    of `checks/<name>.py`) returns; `ctx` holds `win`, `maps`, `session`,
    `config`, `seed`, `keyframes` (`_keyframes`'s list) and `numbers` (this
    file's numbers)."""
    cfg, sensor = config["slam"], config["sensor"]
    scales = None if sensors.SENSORS[sensor].metric else {}
    numbers = pose_numbers(win, sess, sensor, scales)
    kfs = _keyframes(win, maps)
    K = (cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"])
    numbers["map_point_m_by_session"] = {}
    numbers["map_point_m"] = map_number(kfs, sess, K, numbers["map_point_m_by_session"], scales)
    numbers.update(orb_numbers(kfs, sess, cfg, np.random.default_rng(seed)))
    if scales is not None:
        numbers["scale_by_session"] = scales
    ctx = SimpleNamespace(win=win, maps=maps, session=sess, config=config, seed=seed, keyframes=kfs,
                          numbers=dict(numbers))
    for name in limits:
        if name not in NUMBERS:
            numbers[name] = float(checks[name](ctx))
    rows = [(name, float(numbers[name]), float(limits[name])) for name in limits]
    correct = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return correct, rows, numbers
