"""Synthetic textured-plane renderer + the orbit sequence.

Port of the parts of the JAX package's `utils/synthetic.py` the RGB-D slice
needs: `blob_texture` and `make_room` (numpy/scipy, verbatim), `PlaneScene`,
and `render` (per-pixel ray/plane intersection + bilinear texture lookup) in
PyTorch on the scene's device. `orbit_frames` reproduces the headline
benchmark's sequence (bench.py `orbit_frames`): a two-revolution in-place
yaw orbit in the room's first six planes. `stereo_dolly_frames` renders the
rectified pairs of a sideways-and-forward dolly through the whole room
(evaluate.py's `stereo_dolly`, bench.py's KITTI leg). The desk and
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
