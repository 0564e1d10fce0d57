"""The frame stream of a cell: one general generator for every traffic mix.

A traffic file (`traffic/<name>.json`) gives the camera path (`path`: its
`kind` and that kind's parameters; the renderer's `orbit` and `dolly`, or a
`paths/<kind>.py` of the harness), the frames of
one session (`frames`: a range of the path's frame numbers, played `repeat`
times in a row, 1 if not given), the room's planes in view, the frame rate,
the feed (`closed_loop`, the only one the window runs), and how many frames
of the first session are tracked in set-up (`preroll`, 0 if not given). The
frames are rendered once on the device, from `--seed` (the room's textures),
by the reference renderer, and replayed for every session of the window.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import manifest, sensors
from .reference import scene as scene_ref


# The feeds that `window.drive` runs: one client that submits the next frame
# as soon as the last call returns.
FEEDS = ("closed_loop",)


class Session(NamedTuple):
    """Frame k of a session is rendered frame k % n."""

    first: torch.Tensor  # (n, H, W) float32: the images, or the left images of stereo pairs
    second: torch.Tensor | None  # (n, H, W) float32: the depths (RGB-D), the right images (stereo); None (monocular)
    depth: torch.Tensor  # (n, H, W) float32: the true depth of each (left) image
    gt: np.ndarray  # (n, 4, 4) float64: the true Tcw of each rendered frame, world = the room
    timestamps: np.ndarray  # (n * repeat,) float64 seconds of the session's frames


def orbit_poses(frames, total, center):
    return np.stack([scene_ref.orbit_pose(k, total, tuple(center)) for k in frames])


def dolly_poses(frames, step_m):
    dx, dz = step_m
    return np.stack([scene_ref.dolly_pose(k, dx, dz) for k in frames])


# The renderer's own camera paths; any other kind is a file `paths/<kind>.py`.
PATHS = {"orbit": orbit_poses, "dolly": dolly_poses}


def path_function(kind: str, here=manifest.HERE):
    """The `poses(frames, **params)` function of a camera path's kind."""
    return PATHS[kind] if kind in PATHS else manifest.load(here, "paths", kind, "poses")


def path_poses(path: dict, frames, poses=None) -> np.ndarray:
    """True Tcw (n, 4, 4) float32 of the traffic's path at the given frame
    numbers; `poses` is the kind's function where the caller has found it."""
    poses = path_function(path["kind"]) if poses is None else poses
    params = {k: v for k, v in path.items() if k != "kind"}
    gt = np.asarray(poses(frames, **params), np.float32)
    if gt.shape != (len(frames), 4, 4):
        raise ValueError(f"camera path {path['kind']!r} gave poses of shape {gt.shape} for {len(frames)} frames")
    return gt


def camera(slam_cfg: dict):
    return (slam_cfg["fx"], slam_cfg["fy"], slam_cfg["cx"], slam_cfg["cy"])


def render_session(slam_cfg: dict, sensor: str, traffic: dict, seed: int, device, poses=None) -> Session:
    """Render one session of the traffic from the seed's room; `poses` is
    its camera path's function where the caller has found it."""
    spec = sensors.spec(sensor)
    if sensor != traffic["sensor"]:
        raise ValueError(f"traffic {traffic['name']!r} feeds a {traffic['sensor']} camera, not {sensor}")
    if traffic["feed"] not in FEEDS:
        raise ValueError(f"traffic {traffic['name']!r} asks for feed {traffic['feed']!r}; the window runs {FEEDS}")
    room = scene_ref.make_room(np.random.default_rng(seed), device, traffic["room_planes"])
    frames = range(*traffic["frames"])
    gt = path_poses(traffic["path"], frames, poses)
    K, w, h = camera(slam_cfg), slam_cfg["width"], slam_cfg["height"]
    first, right, depth = [], [], []
    for Tcw in gt:
        img, dep = scene_ref.render(room, torch.from_numpy(Tcw).to(device), K, w, h)
        first.append(img)
        depth.append(dep)
        if spec.second == "right":
            Tr = Tcw.copy()
            Tr[0, 3] -= slam_cfg["bf"] / slam_cfg["fx"]
            right.append(scene_ref.render(room, torch.from_numpy(Tr).to(device), K, w, h)[0])
    depth = torch.stack(depth)
    second = depth if spec.second == "depth" else torch.stack(right) if spec.second == "right" else None
    ts = np.arange(len(gt) * traffic.get("repeat", 1)) / float(traffic["rate_hz"])
    return Session(torch.stack(first), second, depth, gt.astype(np.float64), ts)
