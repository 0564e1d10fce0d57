"""Stereo rectification: undistort-rectify maps and a bilinear remap.

Port of the JAX package's `ops/rectify.py` (the reference's
`cv::stereoRectify` + `cv::initUndistortRectifyMap` + `cv::remap`,
src/ros_stereo.cc:71-168):

- `stereo_rectify` (numpy float64, once on the host): rectifying rotations
  and a shared pinhole from a raw stereo calibration, Fusiello style;
- `rectify_map` (host): the rectified-pixel -> source-pixel map of one eye.
  The distortion model runs in float32 through `undistort.distort_normalized`,
  as the reference's does through its jnp twin;
- `remap_bilinear` and `StereoRectifier`: the per-frame resampling, tensors on
  the rectifier's device, both eyes in one batched call.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from .undistort import distort_normalized


def _rodrigues(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _log_so3(R: np.ndarray) -> np.ndarray:
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-12:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th * v / (2.0 * np.sin(th))


def stereo_rectify(K1, D1, K2, D2, R, T, size, alpha_focal: float = 1.0):
    """Rectifying rotations and a shared pinhole for a rig with
    `x_right = R @ x_left + T`. Returns a dict with R1, R2 (applied to each
    eye's rays), K_new (3,3), bf = fx_new * baseline, the baseline, and the
    inputs as float64 arrays."""
    K1 = np.asarray(K1, np.float64).reshape(3, 3)
    K2 = np.asarray(K2, np.float64).reshape(3, 3)
    R = np.asarray(R, np.float64).reshape(3, 3)
    T = np.asarray(T, np.float64).reshape(3)
    W, H = size

    # Each eye turns half the relative rotation.
    om = _log_so3(R)
    R_half_l = _rodrigues(-0.5 * om)
    R_half_r = R_half_l @ R.T

    # The new x-axis runs along the baseline in the halfway frame.
    t = R_half_l @ (-R.T @ T)
    e1 = t / np.linalg.norm(t)
    if e1[0] < 0:
        e1 = -e1
    z = np.array([0.0, 0.0, 1.0])
    e2 = np.cross(z, e1)
    e2 /= np.linalg.norm(e2)
    e3 = np.cross(e1, e2)
    R_align = np.stack([e1, e2, e3])

    f = alpha_focal * 0.25 * (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1])
    K_new = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    baseline = float(np.linalg.norm(T))
    return {
        "R1": R_align @ R_half_l,
        "R2": R_align @ R_half_r,
        "K_new": K_new,
        "bf": f * baseline,
        "baseline": baseline,
        "D1": np.asarray(D1, np.float64).reshape(-1),
        "D2": np.asarray(D2, np.float64).reshape(-1),
        "K1": K1,
        "K2": K2,
    }


def rectify_map(K_src, D_src, R_rect, K_new, size) -> np.ndarray:
    """(H, W, 2) float32 map from each rectified pixel to its source pixel:
    un-project through K_new, rotate back by R_rect^T, distort, project
    through K_src."""
    K_src = np.asarray(K_src, np.float64).reshape(3, 3)
    K_new = np.asarray(K_new, np.float64).reshape(3, 3)
    R_rect = np.asarray(R_rect, np.float64).reshape(3, 3)
    D = np.zeros(5)
    D[: len(np.ravel(D_src))] = np.ravel(D_src)
    W, H = size
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    xn = (u - K_new[0, 2]) / K_new[0, 0]
    yn = (v - K_new[1, 2]) / K_new[1, 1]
    rays = np.stack([xn, yn, np.ones_like(xn)], -1) @ R_rect  # = R^T @ ray
    xs = rays[..., 0] / rays[..., 2]
    ys = rays[..., 1] / rays[..., 2]
    xy = torch.from_numpy(np.stack([xs, ys], -1).astype(np.float32))
    xyd = distort_normalized(xy, torch.from_numpy(D.astype(np.float32))).numpy()
    mu = K_src[0, 0] * xyd[..., 0] + K_src[0, 2]
    mv = K_src[1, 1] * xyd[..., 1] + K_src[1, 2]
    return np.stack([mu, mv], -1).astype(np.float32)


def _remap_batched(imgs: torch.Tensor, maps: torch.Tensor) -> torch.Tensor:
    """imgs (B, H, W) sampled at maps (B, H', W', 2): image b at map b."""
    B, H, W = imgs.shape
    x = torch.clamp(maps[..., 0], 0.0, W - 1.000001)
    y = torch.clamp(maps[..., 1], 0.0, H - 1.000001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    # In float32 the clamp bound W - 1.000001 rounds to W - 1 for W >= 128,
    # so the +1 neighbour can fall one past the edge; it is clamped back,
    # as the reference's gather clamps out-of-range indices.
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    flat = imgs.reshape(B, H * W)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * W + xx).reshape(B, -1)).reshape(yy.shape)

    top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
    bot = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def remap_bilinear(img: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear resample of img (..., H, W) at the source coordinates map_xy
    (H', W', 2); leading dims share the map. Samples outside clamp to the
    border."""
    lead = img.shape[:-2]
    flat = img.reshape(-1, *img.shape[-2:])
    out = _remap_batched(flat, map_xy.expand(flat.shape[0], *map_xy.shape))
    return out.reshape(*lead, *map_xy.shape[:2])


class StereoRectifier:
    """A rig's maps, computed once on the host and kept on `device` (None:
    the card); each call remaps both eyes in one batched resample."""

    def __init__(self, K1, D1, K2, D2, R, T, size, device=None):
        self.device = device_mod.resolve(device)
        self.calib = stereo_rectify(K1, D1, K2, D2, R, T, size)
        c = self.calib
        m_l = rectify_map(c["K1"], c["D1"], c["R1"], c["K_new"], size)
        m_r = rectify_map(c["K2"], c["D2"], c["R2"], c["K_new"], size)
        self.maps = torch.from_numpy(np.stack([m_l, m_r])).to(self.device)  # (2, H, W, 2)
        k = c["K_new"]
        self.K = (float(k[0, 0]), float(k[1, 1]), float(k[0, 2]), float(k[1, 2]))
        self.bf = float(c["bf"])

    def __call__(self, img_left, img_right):
        imgs = torch.stack([torch.as_tensor(img_left, dtype=torch.float32).to(self.device),
                            torch.as_tensor(img_right, dtype=torch.float32).to(self.device)])
        out = _remap_batched(imgs, self.maps)
        return out[0], out[1]
