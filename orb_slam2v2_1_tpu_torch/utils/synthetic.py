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
(`clean_desk_rgbd`, `clean_mono`); `desk_frames` renders them.
`make_adversarial`, `degrade_frame` and `exposure_schedule` are the
adversarial scenes and the photometric degradations of evaluate.py's
`adv_*` legs; `adversarial_frames` renders those legs' sequences with
evaluate.py's random-number order. `ba_problem` is the JAX package's
production-scale bundle-adjustment problem (`__graft_entry__.py`
`_make_problem`), drawn in the same order.
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


def make_adversarial(rng: np.random.Generator, tex_size: int = 512, n_clutter: int = 28,
                     low_texture_frac: float = 0.35, max_tilt_deg: float | None = None,
                     device=None) -> PlaneScene:
    """Adversarial close-range scene on `device` (None: the card): a back
    wall, a desk plane and `n_clutter` randomly oriented, overlapping planes
    (real z-buffer occlusion), with `low_texture_frac` of all surfaces near
    uniform (~6 gray levels). `max_tilt_deg` bounds the clutter normals'
    angle from the camera axis (None: any orientation); the monocular leg
    uses 35 deg, since two-view bootstrapping needs mostly camera-facing
    texture. The draws are the reference's, in its order."""
    device = device_mod.resolve(device)
    planes = [
        ([-3.0, -2.0, 4.0], [6.0, 0.0, 0.0], [0.0, 4.0, 0.0]),  # back wall
        ([-3.0, 1.2, 0.5], [6.0, 0.0, 0.0], [0.0, 0.3, 3.5]),  # floor/desk
    ]
    for _ in range(n_clutter):
        c = np.array([rng.uniform(-2.2, 2.2), rng.uniform(-1.4, 1.0), rng.uniform(1.2, 3.5)])
        if max_tilt_deg is None:
            qq, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        else:
            tilt = np.deg2rad(rng.uniform(0.0, max_tilt_deg))
            azim = rng.uniform(0, 2 * np.pi)
            n = np.array([np.sin(tilt) * np.cos(azim), np.sin(tilt) * np.sin(azim), -np.cos(tilt)])
            roll = rng.uniform(0, 2 * np.pi)
            a = np.cross(n, [0.0, 1.0, 0.0])
            a /= max(np.linalg.norm(a), 1e-9)
            b = np.cross(n, a)
            qq = np.stack([np.cos(roll) * a + np.sin(roll) * b, -np.sin(roll) * a + np.cos(roll) * b, n], axis=1)
        w, h = rng.uniform(0.3, 0.9, 2)
        ux = qq[:, 0] * w
        vy = qq[:, 1] * h
        planes.append((c - ux / 2 - vy / 2, ux, vy))
    tex = []
    for _ in planes:
        t = blob_texture(rng, tex_size)
        if rng.uniform() < low_texture_frac:
            t = 120.0 + (t - t.mean()) * 0.025  # ~6 gray levels of contrast
        tex.append(t)
    o, u, v = (np.asarray([np.asarray(p[i], np.float32) for p in planes]) for i in range(3))
    tex = np.stack(tex).astype(np.float32)
    return PlaneScene(*(torch.from_numpy(a).to(device) for a in (o, u, v, tex)))


def _motion_blur(img: torch.Tensor, direction, length: int) -> torch.Tensor:
    """Directional box blur: the mean of `length` copies of img rolled by
    whole pixels along `direction` (dy, dx). The offsets are rounded in
    float32 on the host, half to even, as the reference's `jnp.round`; the
    mean is the reference's to the bit: a sum in tap order times 1/length."""
    taps = np.arange(length, dtype=np.float32) - np.float32((length - 1) / 2.0)
    offs = np.round(taps[:, None] * np.asarray(direction, np.float32)[None, :]).astype(np.int64)
    acc = None
    for dy, dx in offs:
        tap = torch.roll(img, (int(dy), int(dx)), (0, 1))
        acc = tap if acc is None else acc + tap
    return acc * (1.0 / length)


def degrade_frame(img: torch.Tensor, rng: np.random.Generator, gain: float = 1.0, blur_dir=None,
                  blur_len: int = 0, noise_sigma: float = 0.0) -> torch.Tensor:
    """The camera's photometric degradation of a rendered float32 image, on
    its device: motion blur, exposure gain, sensor noise drawn from `rng`
    (float64 on the host, cast to float32), then rounding and 8-bit
    saturation."""
    out = img
    if blur_len >= 2 and blur_dir is not None:
        out = _motion_blur(out, blur_dir, int(blur_len))
    out = out * gain
    if noise_sigma > 0:
        noise = rng.standard_normal(tuple(img.shape)) * noise_sigma
        out = out + torch.from_numpy(noise.astype(np.float32)).to(img.device)
    return torch.clamp(torch.round(out), 0.0, 255.0)


def exposure_schedule(n_frames: int, rng: np.random.Generator, n_steps: int = 4, lo: float = 0.55,
                      hi: float = 1.7) -> np.ndarray:
    """Piecewise-constant gain (n_frames,) float32 with `n_steps` abrupt
    steps (auto-exposure jumps)."""
    gains = np.ones(n_frames, np.float32)
    cuts = sorted(rng.choice(np.arange(5, n_frames - 1), n_steps, replace=False))
    g = 1.0
    prev = 0
    for c in cuts:
        gains[prev:c] = g
        g = float(rng.uniform(lo, hi))
        prev = c
    gains[prev:] = g
    return gains


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


def desk_frames(cfg, poses, device=None, scene: PlaneScene | None = None):
    """evaluate.py's clean desk sequence: `scene` (default
    `make_desk(default_rng(7))` on `device`, None: the card) seen from
    `poses` (Tcw), each made relative to the first as evaluate.py's `norm`
    does, rendered on the scene's device. Returns (images (n,H,W), depths
    (n,H,W)) tensors and the relative Tcw (n,4,4) float64 numpy,
    evaluate.py's ground truth."""
    desk = make_desk(np.random.default_rng(7), device=device_mod.resolve(device)) if scene is None else scene
    device = desk.tex.device
    K = torch.tensor(cfg.K, dtype=torch.float32, device=device)
    gt = np.stack([p @ np.linalg.inv(poses[0]) for p in poses])
    imgs, deps = [], []
    for Tcw in gt:
        img, depth = render(desk, torch.from_numpy(Tcw.astype(np.float32)).to(device), K, cfg.width, cfg.height)
        imgs.append(img)
        deps.append(depth)
    return torch.stack(imgs), torch.stack(deps), gt


def flow_blur(poses, i: int, cfg, depth: float = 2.2):
    """evaluate.py's `_flow_blur`: the direction (dy, dx) and length in
    pixels (at most 9) of the image motion at the central pixel between
    frames i-1 and i, or (None, 0) below one pixel or at frame 0."""
    if i == 0:
        return None, 0
    rel = poses[i] @ np.linalg.inv(poses[i - 1])
    dx = cfg.fx * (rel[0, 3] / depth - rel[0, 2])
    dy = cfg.fy * (rel[1, 3] / depth - rel[1, 2])
    mag = float(np.hypot(dx, dy))
    if mag < 1.0:
        return None, 0
    d = np.array([dy, dx], np.float32) / max(np.hypot(dx, dy), 1e-6)
    return d, int(min(mag, 9))


# evaluate.py's degradation per sensor (`synth_rgbd`, `synth_mono`,
# `synth_stereo`): (blur, noise sigma, exposure range).
ADVERSARIAL_MODES = {
    "rgbd": (True, 3.0, (0.55, 1.7)),
    "mono": (False, 2.0, (0.7, 1.45)),
    "stereo": (True, 3.0, (0.55, 1.7)),
}


def adversarial_frames(cfg, scene: PlaneScene, poses, rng: np.random.Generator, mode: str):
    """evaluate.py's degraded sequence of `mode` ("rgbd", "mono", "stereo")
    through `scene` along `poses` (Tcw, already relative to the first), on
    the scene's device. One generator is threaded through the exposure
    schedule and then each frame's noise, left eye before right for stereo,
    as evaluate.py's `synth_*` draw it. Returns (images (n,H,W), second
    (n,H,W): the depths, None for mono, the right eyes for stereo)."""
    blur, sigma, (lo, hi) = ADVERSARIAL_MODES[mode]
    dev = scene.tex.device
    K = torch.tensor(cfg.K, dtype=torch.float32, device=dev)
    gains = exposure_schedule(len(poses), rng, lo=lo, hi=hi)
    imgs, second = [], []
    for i, Tcw in enumerate(poses):
        img, depth = render(scene, torch.from_numpy(np.asarray(Tcw, np.float32)).to(dev), K, cfg.width, cfg.height)
        bd, bl = flow_blur(poses, i, cfg) if blur else (None, 0)
        imgs.append(degrade_frame(img, rng, float(gains[i]), bd, bl, sigma))
        if mode == "stereo":
            Tr = np.array(Tcw)  # shifted in the poses' own precision, as evaluate.py does
            Tr[0, 3] -= cfg.bf / cfg.fx
            right, _ = render(scene, torch.from_numpy(Tr.astype(np.float32)).to(dev), K, cfg.width, cfg.height)
            second.append(degrade_frame(right, rng, float(gains[i]), bd, bl, sigma))
        elif mode == "rgbd":
            second.append(depth)
    return torch.stack(imgs), (torch.stack(second) if second else None)


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


def ba_problem(rng: np.random.Generator, C: int, Pn: int, O: int, device=None):
    """A bundle-adjustment problem of the size a full map gives: C cameras on
    a lateral arc observing Pn points through O stereo observations with
    0.3 px of noise (those out of the image or closer than 0.5 m invalid),
    the poses perturbed by 0.01 in the tangent and the points by 0.05 m,
    camera 0 fixed. The JAX package's `__graft_entry__._make_problem`, drawn
    from `rng` in its order, on `device` (None: the card). Returns an
    `ops.ba.BAProblem`."""
    from ..ops import ba
    from ..ops.projection import project_stereo

    device = device_mod.resolve(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    K = t([450.0, 450.0, 320.0, 240.0])
    bf = 40.0
    pts = t(np.stack([rng.uniform(-6, 6, Pn), rng.uniform(-4, 4, Pn), rng.uniform(4, 14, Pn)], -1))
    xi = np.zeros((C, 6), np.float32)
    xi[:, 0] = np.linspace(-1.5, 1.5, C)  # lateral arc
    xi[:, 4] = np.linspace(-0.15, 0.15, C)  # gentle yaw
    poses = lie.se3_exp(t(xi))
    cam_idx = t(rng.integers(0, C, O), torch.int32)
    pt_idx = t(rng.integers(0, Pn, O), torch.int32)
    Tc, pw = poses[cam_idx.long()], pts[pt_idx.long()]
    target = project_stereo(Tc, pw, K, bf)
    target = target + t(rng.normal(0, 0.3, tuple(target.shape)))
    z = (Tc[:, 2, :3] * pw).sum(-1) + Tc[:, 2, 3]
    in_img = (target[:, 0] > 0) & (target[:, 0] < 640) & (target[:, 1] > 0) & (target[:, 1] < 480) & (z > 0.5)
    obs = ba.Obs(cam_idx=cam_idx, pt_idx=pt_idx, target=target, inv_sigma2=torch.ones(O, device=device),
                 is_stereo=torch.ones(O, dtype=torch.bool, device=device), valid=in_img)
    cam_fixed = torch.zeros(C, dtype=torch.bool, device=device)
    cam_fixed[0] = True
    poses_n = lie.se3_exp(t(rng.normal(0, 0.01, (C, 6)))) @ poses
    poses_n = torch.where(cam_fixed[:, None, None], poses, poses_n)
    pts_n = pts + t(rng.normal(0, 0.05, tuple(pts.shape)))
    return ba.BAProblem(poses=poses_n, points=pts_n, obs=obs, cam_fixed=cam_fixed, K=K, bf=bf)
