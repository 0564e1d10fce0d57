"""The benchmark's scene, camera paths and renderer: plain NumPy and PyTorch.

A frozen copy of the textured-plane room of the SLAM port's synthetic data
(`blob_texture`, `make_room`), its two camera paths (the two-revolution
orbit about the point (0, 0, 3) and the forward-lateral dolly) and its
ray-plane renderer. The benchmark renders every frame it feeds the program
with it, and the correctness check renders the depth it compares the map
against with it. It imports nothing of the program.

The room's textures come from `numpy.random.default_rng(seed)`: the seed
changes what the camera sees, never the room's geometry or the path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# The renderer uses matrix products: keep them in float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class PlaneScene(NamedTuple):
    origin: torch.Tensor  # (P, 3) plane corner
    ux: torch.Tensor  # (P, 3) texture u axis, its length the plane's width in metres
    vy: torch.Tensor  # (P, 3) texture v axis
    tex: torch.Tensor  # (P, T, T) float32 textures


def blob_texture(rng: np.random.Generator, size: int = 512) -> np.ndarray:
    """Multi-scale filtered noise in [10, 245]: locally unique, rich in corners."""
    from scipy.ndimage import gaussian_filter

    img = np.zeros((size, size), np.float32)
    for sigma, amp in ((1.5, 1.0), (3.0, 1.2), (6.0, 1.5), (12.0, 1.5)):
        img += amp * gaussian_filter(rng.standard_normal((size, size)), sigma).astype(np.float32)
    img -= img.min()
    img *= 235.0 / max(img.max(), 1e-6)
    return img + 10.0


# The 8 x 6 x 4 m room: floor, ceiling, four walls (corner, u axis, v axis),
# then five boxes at 2-5 m, two faces each (x, y, z, width, height).
ROOM_PLANES = (
    ([-4.0, 2.0, 0.0], [8.0, 0.0, 0.0], [0.0, 0.0, 8.0]),
    ([-4.0, -2.0, 0.0], [8.0, 0.0, 0.0], [0.0, 0.0, 8.0]),
    ([-4.0, -2.0, 8.0], [8.0, 0.0, 0.0], [0.0, 4.0, 0.0]),
    ([-4.0, -2.0, 0.0], [0.0, 0.0, 8.0], [0.0, 4.0, 0.0]),
    ([4.0, -2.0, 0.0], [0.0, 0.0, 8.0], [0.0, 4.0, 0.0]),
    ([-4.0, -2.0, 0.0], [8.0, 0.0, 0.0], [0.0, 4.0, 0.0]),
)
ROOM_BOXES = (
    (-2.5, 0.2, 3.0, 1.2, 1.4),
    (0.6, -0.5, 4.2, 1.5, 1.8),
    (-0.8, 0.6, 2.2, 0.9, 1.0),
    (2.0, -0.2, 5.0, 1.4, 1.6),
    (-3.0, -1.0, 5.5, 1.6, 1.6),
)


def make_room(rng: np.random.Generator, device, n_planes: int | None = None) -> PlaneScene:
    """The room with every plane's texture drawn from `rng` in plane order,
    on `device`; `n_planes` keeps the first planes only (the orbit sees the
    six walls, floor and ceiling)."""
    planes = list(ROOM_PLANES)
    for bx, by, bz, w, h in ROOM_BOXES:
        planes.append(([bx, by, bz], [w, 0.0, 0.0], [0.0, h, 0.0]))
        planes.append(([bx + w, by, bz], [0.0, 0.0, 1.0], [0.0, h, 0.0]))
    tex = np.stack([blob_texture(rng) for _ in planes])
    o, u, v = (np.asarray([p[i] for p in planes], np.float32) for i in range(3))
    n = len(planes) if n_planes is None else n_planes
    return PlaneScene(*(torch.from_numpy(a[:n]).to(device) for a in (o, u, v, tex)))


def so3_exp(phi) -> np.ndarray:
    """Rodrigues' formula in float64: axis-angle (3,) -> rotation (3, 3)."""
    phi = np.asarray(phi, np.float64)
    th = float(np.linalg.norm(phi))
    W = np.array([[0.0, -phi[2], phi[1]], [phi[2], 0.0, -phi[0]], [-phi[1], phi[0], 0.0]])
    if th < 1e-8:
        return np.eye(3) + W + 0.5 * W @ W
    return np.eye(3) + np.sin(th) / th * W + (1.0 - np.cos(th)) / th**2 * W @ W


def orbit_pose(k: int, total: int, center=(0.0, 0.0, 3.0)) -> np.ndarray:
    """Tcw (4, 4) float32 of frame k of a `total`-frame two-revolution yaw
    orbit in place at `center`."""
    Twc = np.eye(4)
    Twc[:3, :3] = so3_exp([0.0, 4.0 * np.pi * k / total, 0.0])
    Twc[:3, 3] = center
    return np.linalg.inv(Twc).astype(np.float32)


def dolly_pose(i: int, dx: float, dz: float) -> np.ndarray:
    """Tcw (4, 4) float32 of step i of the dolly: +dx in x and +dz in z a
    step, facing +z."""
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -dx * i
    T[2, 3] = -dz * i
    return T


def render(scene: PlaneScene, Tcw: torch.Tensor, K, width: int, height: int):
    """(image, depth), each (height, width) float32 on the scene's device:
    the nearest plane hit by each pixel's ray, its texture sampled
    bilinearly; depth is the ray parameter (z in the camera) and 0 where no
    plane is hit. K is (fx, fy, cx, cy)."""
    dev = scene.tex.device
    R_cw, t_cw = Tcw[:3, :3], Tcw[:3, 3]
    R = R_cw.T
    cam_o = -(R @ t_cw)
    ys, xs = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev), indexing="ij")
    fx, fy, cx, cy = (float(np.float32(k)) for k in K)
    dirs_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones((height, width), device=dev)], -1)
    dirs = dirs_cam @ R.T

    T = scene.tex.shape[-1]
    n = torch.linalg.cross(scene.ux, scene.vy)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    denom = torch.einsum("hwk,pk->phw", dirs, n)
    num = torch.sum((scene.origin - cam_o) * n, dim=-1)
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
    u0, v0 = torch.floor(fu).long(), torch.floor(fv).long()
    u1, v1 = torch.clamp(u0 + 1, max=T - 1), torch.clamp(v0 + 1, max=T - 1)
    au, av = fu - u0, fv - v0
    p = torch.arange(scene.tex.shape[0], device=dev)[:, None, None]
    tex = scene.tex
    val = (tex[p, v0, u0] * (1 - au) * (1 - av) + tex[p, v0, u1] * au * (1 - av)
           + tex[p, v1, u0] * (1 - au) * av + tex[p, v1, u1] * au * av)
    ts = torch.where(ok, tt, float("inf"))
    best = torch.argmin(ts, dim=0)[None]
    img = torch.gather(torch.where(ok, val, 0.0), 0, best)[0]
    depth = torch.gather(ts, 0, best)[0]
    return img, torch.where(torch.isinf(depth), 0.0, depth)
