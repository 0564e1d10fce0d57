"""A made-up run for the correctness check: a window, the maps it left and
the rendered session, built from the truth on the CPU without the program.

The published poses and the maps' points are the truth moved by a
similarity (scale `scale`, rotation `rot`, shift `shift`), with `noise`
added where asked; the keyframes' features are the plain ORB's of their
frames, with `orb_faults` of them altered. Every point is the reference's
own back-projection of its keypoint at the rendered depth, so a map that is
the truth reads a gap of 0.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench import stream, window
from slam_bench.reference import orb as orb_ref
from slam_bench.reference import scene as scene_ref
from slam_bench.reference import trajectory as traj_ref

CFG = dict(width=160, height=120, fx=137.5, fy=137.5, cx=80.0, cy=60.0, bf=44.0, n_features=300, n_levels=8,
           scale_factor=1.2, fast_threshold=20.0, fast_min_threshold=7.0)
FRAMES = 10
# Per session: the frames submitted, the keyframes, the frames never
# published and the frames published as lost.
SESSIONS = ({"frames": 10, "keyframes": (0, 3, 7), "unpublished": (), "lost": ()},
            {"frames": 6, "keyframes": (0, 4), "unpublished": (5,), "lost": (2,)})
POINTS_PER_KF = 40


def config(sensor: str) -> dict:
    """A configuration's file as `check.judge` takes it: the sensor and the
    camera and ORB sizes."""
    return {"sensor": sensor, "slam": CFG}


def session(seed: int = 3) -> stream.Session:
    """Frames 0-9 of a dolly through the whole room (0.08 m in x and 0.05 m
    in z a frame)."""
    room = scene_ref.make_room(np.random.default_rng(seed), "cpu")
    gt = np.stack([scene_ref.dolly_pose(i, 0.08, 0.05) for i in range(FRAMES)])
    K = stream.camera(CFG)
    imgs, deps = zip(*(scene_ref.render(room, torch.from_numpy(T), K, CFG["width"], CFG["height"]) for T in gt))
    depth = torch.stack(deps)
    return stream.Session(torch.stack(imgs), depth, depth, gt.astype(np.float64), np.arange(FRAMES) / 30.0)


def _pack(bits: np.ndarray) -> np.ndarray:
    """(n, 256) bool -> (n, 8) int32 words, bit b of word w = bit 32w+b."""
    w = (bits.reshape(-1, 8, 32).astype(np.int64) << np.arange(32)).sum(-1)
    return w.astype(np.uint32).view(np.int32)


def _moved(Tcw: np.ndarray, scale: float, rot: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """The pose of the same camera in the world moved by X -> scale rot X + shift."""
    c = traj_ref.centers(Tcw[None])[0]
    R = Tcw[:3, :3] @ rot.T
    out = np.eye(4)
    out[:3, :3] = R
    out[:3, 3] = -R @ (scale * rot @ c + shift)
    return out


def run(sess: stream.Session, scale: float = 1.0, rot_deg: float = 0.0, shift=(0.0, 0.0, 0.0),
        noise: float = 0.0, orb_faults: int = 0, seed: int = 5, sessions=SESSIONS):
    """(win, maps): the window of `sessions` and the map each session left."""
    rng = np.random.default_rng(seed)
    rot = scene_ref.so3_exp(np.radians(rot_deg) * np.array([0.3, 0.9, 0.3]) / np.linalg.norm([0.3, 0.9, 0.3]))
    shift = np.asarray(shift, np.float64)
    K = stream.camera(CFG)
    win = window.Window(seconds=1.0, rate_hz=30.0, session=len(sessions) - 1)
    maps = []
    for s, spec in enumerate(sessions):
        win.frame_of_id.append({})
        for k in range(spec["frames"]):
            win.submitted[(s, k)] = 0.01 * k
            if k in spec["unpublished"]:
                continue
            T = _moved(sess.gt[k], scale, rot, shift)
            if noise:
                T[:3, :3] = scene_ref.so3_exp(rng.normal(0.0, noise, 3)) @ T[:3, :3]
                T[:3, 3] += rng.normal(0.0, noise, 3)
            win.published[(s, k)] = (0.02 + 0.01 * k, None if k in spec["lost"] else T)
        n_kf = len(spec["keyframes"])
        m = {"kf_valid": np.ones(n_kf, bool), "kf_pose": np.zeros((n_kf, 4, 4)),
             "kf_frame_id": np.zeros(n_kf, np.int64), "kf_xy": np.zeros((n_kf, CFG["n_features"], 2), np.float32),
             "kf_level": np.zeros((n_kf, CFG["n_features"]), np.int32),
             "kf_kp_valid": np.zeros((n_kf, CFG["n_features"]), bool),
             "kf_desc": np.zeros((n_kf, CFG["n_features"], 8), np.int32),
             "kf_mp": np.full((n_kf, CFG["n_features"]), -1, np.int64)}
        points = []
        for slot, k in enumerate(spec["keyframes"]):
            fid = 100 * s + 7 + k  # the program's frame ids need not be k
            win.frame_of_id[s][fid] = k
            xy, lv, ok, bits = (t.numpy() for t in orb_ref.extract(
                sess.first[k], CFG["n_features"], CFG["n_levels"], CFG["scale_factor"], CFG["fast_threshold"],
                CFG["fast_min_threshold"]))
            xy, desc = xy.copy(), _pack(bits)
            v = np.flatnonzero(ok)
            xy[v[:orb_faults]] += 0.5  # keypoints moved
            desc[v[orb_faults:2 * orb_faults], 0] ^= -1  # a descriptor word inverted
            m["kf_frame_id"][slot], m["kf_xy"][slot], m["kf_level"][slot] = fid, xy, lv
            m["kf_kp_valid"][slot], m["kf_desc"][slot] = ok, desc
            m["kf_pose"][slot] = _moved(sess.gt[k], scale, rot, shift)
            d = traj_ref.sample_depth(sess.depth[k].numpy().astype(np.float64), xy.astype(np.float64))
            obs = np.flatnonzero(ok & (d > 0))[:POINTS_PER_KF]
            Xc = traj_ref.back_project(xy[obs].astype(np.float64), d[obs], K)
            R, t = sess.gt[k][:3, :3], sess.gt[k][:3, 3]
            X = scale * (Xc - t) @ R @ rot.T + shift
            if noise:
                X = X + rng.normal(0.0, noise, X.shape)
            m["kf_mp"][slot, obs] = sum(map(len, points)) + np.arange(len(obs))
            points.append(X)
        pos = np.concatenate(points)
        valid = np.ones(len(pos), bool)
        valid[::9] = False  # points the mapper culled
        m["mp_pos"], m["mp_valid"] = pos, valid
        maps.append({f: torch.from_numpy(np.ascontiguousarray(a)) for f, a in m.items()})
    return win, maps
