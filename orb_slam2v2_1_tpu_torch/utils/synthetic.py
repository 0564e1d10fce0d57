"""Synthetic textured-plane renderer + the orbit sequence.

Port of the parts of the JAX package's `utils/synthetic.py` the RGB-D slice
needs: `blob_texture` and `make_room` (numpy/scipy, verbatim), `PlaneScene`,
and `render` (per-pixel ray/plane intersection + bilinear texture lookup) in
PyTorch on the scene's device. `orbit_frames` reproduces the headline
benchmark's sequence (bench.py `orbit_frames`): a two-revolution in-place
yaw orbit in the room's first six planes. `stereo_dolly_frames` renders the
rectified pairs of a sideways-and-forward dolly through the whole room
(evaluate.py's `stereo_dolly`, bench.py's KITTI leg). `make_desk`,
`desk_trajectory` and `lateral_trajectory` give evaluate.py's desk sequences
(`clean_desk_rgbd`, `clean_mono`); `desk_frames` renders them. The
adversarial scenes and the photometric degradations are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..ops import lie


class PlaneScene(NamedTuple):
    origin: torch.Tensor  # (P,3) plane corner
    ux: torch.Tensor  # (P,3) texture u axis (length = width in meters)
    vy: torch.Tensor  # (P,3) texture v axis
    tex: torch.Tensor  # (P,T,T) f32 textures


def blob_texture(rng: np.random.Generator, size: int = 512, n_blobs: int = 900) -> np.ndarray:
    """Multi-scale filtered noise: locally unique, corner-rich texture."""
    del n_blobs
    from scipy.ndimage import gaussian_filter

    img = np.zeros((size, size), np.float32)
    for sigma, amp in ((1.5, 1.0), (3.0, 1.2), (6.0, 1.5), (12.0, 1.5)):
        img += amp * gaussian_filter(rng.standard_normal((size, size)), sigma).astype(np.float32)
    img -= img.min()
    img *= 235.0 / max(img.max(), 1e-6)
    return img + 10.0


def make_room(rng: np.random.Generator, tex_size: int = 512, device=None) -> PlaneScene:
    """A 8x6x4 m room with mid-room boxes at 2-5 m (strong depth variation),
    on `device` (None: the card, see `device.resolve`)."""
    device = device_mod.resolve(device)
    planes = [
        ([-4.0, 2.0, 0.0], [8.0, 0.0, 0.0], [0.0, 0.0, 8.0]),  # floor y=+2
        ([-4.0, -2.0, 0.0], [8.0, 0.0, 0.0], [0.0, 0.0, 8.0]),  # ceiling y=-2
        ([-4.0, -2.0, 8.0], [8.0, 0.0, 0.0], [0.0, 4.0, 0.0]),  # back wall z=8
        ([-4.0, -2.0, 0.0], [0.0, 0.0, 8.0], [0.0, 4.0, 0.0]),  # left wall x=-4
        ([4.0, -2.0, 0.0], [0.0, 0.0, 8.0], [0.0, 4.0, 0.0]),  # right wall x=+4
        ([-4.0, -2.0, 0.0], [8.0, 0.0, 0.0], [0.0, 4.0, 0.0]),  # front wall z=0
    ]
    boxes = [
        (-2.5, 0.2, 3.0, 1.2, 1.4),
        (0.6, -0.5, 4.2, 1.5, 1.8),
        (-0.8, 0.6, 2.2, 0.9, 1.0),
        (2.0, -0.2, 5.0, 1.4, 1.6),
        (-3.0, -1.0, 5.5, 1.6, 1.6),
    ]
    for (bx, by, bz, w, h) in boxes:
        planes.append(([bx, by, bz], [w, 0.0, 0.0], [0.0, h, 0.0]))
        planes.append(([bx + w, by, bz], [0.0, 0.0, 1.0], [0.0, h, 0.0]))
    tex = np.stack([blob_texture(rng, tex_size) for _ in planes])
    o, u, v = (np.asarray([p[i] for p in planes], np.float32) for i in range(3))
    return PlaneScene(*(torch.from_numpy(a).to(device) for a in (o, u, v, tex)))


def make_desk(rng: np.random.Generator, tex_size: int = 512, device=None) -> PlaneScene:
    """Desk-like close-range scene (the TUM fr1 benchmark character): a wall
    at 3.5 m, a tilted desk plane, and a clutter of boxes at 1.3-2.8 m that
    fill most of the view from the origin; on `device` (None: the card)."""
    device = device_mod.resolve(device)
    planes = [
        ([-3.0, -2.0, 3.5], [6.0, 0.0, 0.0], [0.0, 4.0, 0.0]),  # back wall
        ([-3.0, 1.0, 0.5], [6.0, 0.0, 0.0], [0.0, 0.5, 3.0]),  # desk (tilted top)
    ]
    boxes = [
        (-1.8, -1.0, 1.6, 0.8, 1.0),
        (-0.6, -0.3, 1.4, 0.7, 0.9),
        (0.5, -1.2, 1.9, 0.9, 1.1),
        (1.4, 0.0, 1.5, 0.8, 0.8),
        (-2.4, 0.2, 2.3, 1.0, 0.8),
        (0.0, 0.5, 2.1, 1.2, 0.6),
        (-1.0, -1.8, 2.6, 1.3, 1.0),
        (1.8, -0.9, 2.8, 1.1, 1.2),
    ]
    for (bx, by, bz, w, h) in boxes:
        planes.append(([bx, by, bz], [w, 0.0, 0.0], [0.0, h, 0.0]))
        planes.append(([bx + w, by, bz], [0.0, 0.0, 0.6], [0.0, h, 0.0]))
    tex = np.stack([blob_texture(rng, tex_size) for _ in planes])
    o, u, v = (np.asarray([p[i] for p in planes], np.float32) for i in range(3))
    return PlaneScene(*(torch.from_numpy(a).to(device) for a in (o, u, v, tex)))


def _tcw_of(xi: np.ndarray) -> np.ndarray:
    """World->camera pose of the camera whose Twc = se3_exp(xi)."""
    Twc = lie.se3_exp(torch.from_numpy(np.asarray(xi, np.float32))).numpy()
    return np.linalg.inv(Twc).astype(np.float32)


def desk_trajectory(n_frames: int, extent: float = 0.7) -> list[np.ndarray]:
    """fr1/xyz-like sweep: lateral and vertical translation with a gentle yaw
    that keeps the desk centred. Returns a list of Tcw (world = first
    camera)."""
    poses = []
    look_z = 2.2  # fixation depth
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        x = extent * np.sin(2 * np.pi * s)
        y = 0.25 * np.sin(4 * np.pi * s)
        z = 0.15 * np.sin(2 * np.pi * s + 1.0)
        yaw = -np.arctan2(x, look_z)
        poses.append(_tcw_of(np.array([x, y, z, 0.0, yaw, 0.0], np.float32)))
    return poses


def lateral_trajectory(n_frames: int, extent: float = 1.5) -> list[np.ndarray]:
    """Smooth lateral sweep with a slight yaw, the parallax a monocular
    initialization needs. Returns a list of Tcw (world = first camera)."""
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        x = extent * np.sin(2 * np.pi * s * 0.5)
        yaw = 0.1 * np.sin(2 * np.pi * s)
        poses.append(_tcw_of(np.array([x, 0.1 * np.sin(4 * np.pi * s), 0.3 * s, 0.0, yaw, 0.0], np.float32)))
    return poses


def desk_frames(cfg, poses, device=None):
    """evaluate.py's clean desk sequence: `make_desk(default_rng(7))` seen
    from `poses` (Tcw), each made relative to the first as evaluate.py's
    `norm` does, rendered on `device` (None: the card). Returns (images
    (n,H,W), depths (n,H,W)) tensors and the relative Tcw (n,4,4) float64
    numpy, evaluate.py's ground truth."""
    device = device_mod.resolve(device)
    desk = make_desk(np.random.default_rng(7), device=device)
    K = torch.tensor(cfg.K, dtype=torch.float32, device=device)
    gt = np.stack([p @ np.linalg.inv(poses[0]) for p in poses])
    imgs, deps = [], []
    for Tcw in gt:
        img, depth = render(desk, torch.from_numpy(Tcw.astype(np.float32)).to(device), K, cfg.width, cfg.height)
        imgs.append(img)
        deps.append(depth)
    return torch.stack(imgs), torch.stack(deps), gt


def render(scene: PlaneScene, Tcw: torch.Tensor, K: torch.Tensor, width: int, height: int):
    """Render (img, depth), each (height, width) float32, on the scene's
    device; depth is 0 where no plane is hit."""
    dev = scene.tex.device
    Twc = lie.se3_inverse(Tcw)
    cam_o = Twc[:3, 3]
    R = Twc[:3, :3]
    ys, xs = torch.meshgrid(
        torch.arange(height, device=dev), torch.arange(width, device=dev), indexing="ij"
    )
    dirs_cam = torch.stack(
        [(xs - K[2]) / K[0], (ys - K[3]) / K[1], torch.ones((height, width), dtype=torch.float32, device=dev)],
        -1,
    )
    dirs = dirs_cam @ R.T  # (H,W,3) world

    T = scene.tex.shape[-1]
    n = torch.linalg.cross(scene.ux, scene.vy)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)  # (P,3)
    denom = torch.einsum("hwk,pk->phw", dirs, n)
    num = torch.sum((scene.origin - cam_o) * n, dim=-1)  # (P,)
    tt = num[:, None, None] / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    hit = cam_o + tt[..., None] * dirs[None]
    rel = hit - scene.origin[:, None, None, :]
    uu = torch.einsum("phwk,pk->phw", rel, scene.ux) / torch.clamp(
        torch.sum(scene.ux * scene.ux, -1), min=1e-9)[:, None, None]
    vv = torch.einsum("phwk,pk->phw", rel, scene.vy) / torch.clamp(
        torch.sum(scene.vy * scene.vy, -1), min=1e-9)[:, None, None]
    ok = (tt > 0.05) & (uu >= 0) & (uu < 1) & (vv >= 0) & (vv < 1)

    fu = torch.clamp(uu * (T - 1), 0, T - 1)
    fv = torch.clamp(vv * (T - 1), 0, T - 1)
    u0 = torch.floor(fu).long()
    v0 = torch.floor(fv).long()
    u1 = torch.clamp(u0 + 1, max=T - 1)
    v1 = torch.clamp(v0 + 1, max=T - 1)
    au = fu - u0
    av = fv - v0
    p = torch.arange(scene.tex.shape[0], device=dev)[:, None, None]
    tex = scene.tex
    val = (
        tex[p, v0, u0] * (1 - au) * (1 - av)
        + tex[p, v0, u1] * au * (1 - av)
        + tex[p, v1, u0] * (1 - au) * av
        + tex[p, v1, u1] * au * av
    )
    ts = torch.where(ok, tt, float("inf"))
    vals = torch.where(ok, val, 0.0)
    best = torch.argmin(ts, dim=0)[None]
    img = torch.gather(vals, 0, best)[0]
    depth = torch.gather(ts, 0, best)[0]
    return img, torch.where(torch.isinf(depth), 0.0, depth)


def orbit_pose(k: int, total: int) -> np.ndarray:
    """Ground-truth Tcw of frame k of a `total`-frame two-revolution orbit
    about the point (0, 0, 3) of the room."""
    th = 2.0 * 2 * np.pi * k / total
    R = lie.so3_exp(torch.tensor([0.0, th, 0.0], dtype=torch.float32)).numpy()
    Twc = np.eye(4, dtype=np.float32)
    Twc[:3, :3] = R
    Twc[:3, 3] = np.array([0.0, 0.0, 3.0], np.float32)
    return np.linalg.inv(Twc).astype(np.float32)


def orbit_frames(cfg, n_frames: int, device=None, total: int | None = None):
    """Frames 0..n_frames-1 of the benchmark's `total`-frame orbit (default
    total = n_frames), rendered on `device` (None: the card). Returns (images (n,H,W),
    depths (n,H,W)) tensors and the ground-truth Tcw (n,4,4) numpy."""
    device = device_mod.resolve(device)
    total = n_frames if total is None else total
    rng = np.random.default_rng(11)
    room = make_room(rng, device=device)
    scene = PlaneScene(room.origin[:6], room.ux[:6], room.vy[:6], room.tex[:6])
    K = torch.tensor(cfg.K, dtype=torch.float32, device=device)
    gt = np.stack([orbit_pose(k, total) for k in range(n_frames)])
    imgs, deps = [], []
    for k in range(n_frames):
        img, depth = render(scene, torch.from_numpy(gt[k]).to(device), K, cfg.width, cfg.height)
        imgs.append(img)
        deps.append(depth)
    return torch.stack(imgs), torch.stack(deps), gt


def dolly_pose(i: int, dx: float = 0.05, dz: float = 0.04) -> np.ndarray:
    """Tcw of step i of the dolly: the camera moves +dx in x and +dz in z per
    step, facing +z (evaluate.py `stereo_dolly`; bench.py's KITTI leg uses
    dx=0.08, dz=0.05)."""
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -dx * i
    T[2, 3] = -dz * i
    return T


def stereo_dolly_frames(cfg, steps, rng: np.random.Generator, device=None, dx: float = 0.05, dz: float = 0.04):
    """Rectified stereo pairs at the given dolly steps in `make_room(rng)`,
    the right camera shifted by the baseline bf / fx, rendered on `device`
    (None: the card). Returns (left (n,H,W), right (n,H,W)) tensors and the
    ground-truth Tcw (n,4,4) numpy."""
    device = device_mod.resolve(device)
    room = make_room(rng, device=device)
    K = torch.tensor(cfg.K, dtype=torch.float32, device=device)
    gt = np.stack([dolly_pose(i, dx, dz) for i in steps])
    lefts, rights = [], []
    for Tcw in gt:
        Tr = Tcw.copy()
        Tr[0, 3] -= cfg.bf / cfg.fx
        lefts.append(render(room, torch.from_numpy(Tcw).to(device), K, cfg.width, cfg.height)[0])
        rights.append(render(room, torch.from_numpy(Tr).to(device), K, cfg.width, cfg.height)[0])
    return torch.stack(lefts), torch.stack(rights), gt
