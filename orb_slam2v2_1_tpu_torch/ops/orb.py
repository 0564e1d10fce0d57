"""Oriented-FAST + rotated-BRIEF extraction, batched over keypoints.

Port of the JAX package's `ops/orb.py`. The BRIEF pattern is the reference's
seeded Gaussian pattern (`np.random.default_rng(1234)`), and the steering is
angle-binned into N_ANGLE_BINS fixed tap sets (`_make_select_matrices`,
carried over verbatim). The reference applies a bin's taps as one one-hot
matrix product; the port gathers the same taps by index (`_TAP_IDX`, the
row of the single 1 in each column of that matrix), which gives the same
values without a (K, 961) x (961, 16384) product.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import fast as fast_ops
from . import hamming
from . import image as image_ops

HALF_PATCH = 15
PATCH = 2 * HALF_PATCH + 1  # 31
PATTERN_RADIUS = 13
N_ANGLE_BINS = 32

BLUR_SIZE = 9
BLUR_PAD = BLUR_SIZE // 2
GATHER_HALF = HALF_PATCH + BLUR_PAD  # 19 == select_keypoints border


def _make_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 4) int32 of (ay, ax, by, bx) BRIEF tap pairs in patch coords."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < 512:
        p = rng.normal(0.0, PATCH / 5.0, size=2)
        if np.linalg.norm(p) <= PATTERN_RADIUS:
            pts.append(p)
    pts = np.round(np.asarray(pts)).astype(np.int32)
    return np.concatenate([pts[0::2], pts[1::2]], axis=1)


def _orientation_mask() -> np.ndarray:
    """(31, 31) float32 disc mask of radius HALF_PATCH."""
    ys, xs = np.mgrid[-HALF_PATCH: HALF_PATCH + 1, -HALF_PATCH: HALF_PATCH + 1]
    return (ys**2 + xs**2 <= HALF_PATCH**2).astype(np.float32)


def _make_select_matrices(pattern: np.ndarray) -> np.ndarray:
    """(961, N_BINS*512) one-hot: column block b holds [a-taps | b-taps]
    for bin b's center angle."""
    S = np.zeros((N_ANGLE_BINS, PATCH * PATCH, 512), np.float32)
    ay, ax, by, bx = pattern.T.astype(np.float64)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        for (y, x, col) in ((ay, ax, 0), (by, bx, 256)):
            ry = np.round(sa * x + ca * y).astype(np.int64) + HALF_PATCH
            rx = np.round(ca * x - sa * y).astype(np.int64) + HALF_PATCH
            S[b, ry * PATCH + rx, col + np.arange(256)] = 1.0
    return S.transpose(1, 0, 2).reshape(PATCH * PATCH, N_ANGLE_BINS * 512)


def _make_tap_index(pattern: np.ndarray) -> np.ndarray:
    """(N_BINS, 512) int64 flat patch index of each tap: the row holding the
    1 of each column of `_make_select_matrices(pattern)`."""
    S = _make_select_matrices(pattern)
    return np.argmax(S, axis=0).reshape(N_ANGLE_BINS, 512).astype(np.int64)


_PATTERN = _make_pattern()  # (256, 4) numpy
_DISC = _orientation_mask()  # (31, 31) numpy
_TAP_IDX = _make_tap_index(_PATTERN)  # (32, 512) numpy


class OrbFeatures(NamedTuple):
    """Fixed-capacity per-frame feature set."""

    xy: torch.Tensor  # (N, 2) float32 (x, y) in level-0 pixel coords
    level: torch.Tensor  # (N,) int32
    angle: torch.Tensor  # (N,) float32 radians
    response: torch.Tensor  # (N,) float32
    desc: torch.Tensor  # (N, 8) int32 packed descriptor words
    desc_pm1: torch.Tensor  # (N, 256) float32 +-1
    valid: torch.Tensor  # (N,) bool


def _gather_patches(img: torch.Tensor, yx: torch.Tensor, half: int = HALF_PATCH) -> torch.Tensor:
    """Gather (2*half+1)^2 patches centered at yx (K, 2) -> (K, P, P), with
    `lax.dynamic_slice`'s start rule (`image.gather_windows`; it only moves
    padding keypoints: valid ones sit >= the border from the edge)."""
    size = 2 * half + 1
    return image_ops.gather_windows(img, yx[:, 0] - half, yx[:, 1] - half, size, size)


def blur_patches(raw: torch.Tensor, sigma: float = 3.0) -> torch.Tensor:
    """(K, 39, 39) raw patches -> (K, 31, 31) Gaussian-blurred (VALID)."""
    k = image_ops._gauss_kernel(BLUR_SIZE, sigma, device=raw.device)
    x = raw[:, None]
    x = F.conv2d(x, k.view(1, 1, 1, BLUR_SIZE))
    x = F.conv2d(x, k.view(1, 1, BLUR_SIZE, 1))
    return x[:, 0]


def ic_angle(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per patch (K, 31, 31) -> (K,) radians."""
    dev = patches.device
    w = patches * torch.from_numpy(_DISC).to(dev)
    g = torch.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=torch.float32, device=dev)
    m10 = torch.sum(w * g[None, None, :], dim=(1, 2))
    m01 = torch.sum(w * g[None, :, None], dim=(1, 2))
    return torch.atan2(m01, m10)


def brief_descriptors(patches: torch.Tensor, angles: torch.Tensor):
    """Steered BRIEF over blurred patches (K, 31, 31), angles (K,).
    Returns (packed (K, 8) int32 words, pm1 (K, 256) float32)."""
    K = patches.shape[0]
    flat = patches.reshape(K, -1)
    frac = angles / (2.0 * math.pi) * N_ANGLE_BINS
    bin_idx = torch.remainder(torch.round(frac).to(torch.int64), N_ANGLE_BINS)
    taps_idx = torch.from_numpy(_TAP_IDX).to(patches.device)[bin_idx]  # (K, 512)
    sel = torch.gather(flat, 1, taps_idx)
    bits = sel[:, :256] < sel[:, 256:]
    return hamming.pack_bits(bits), bits.to(torch.float32) * 2 - 1


class OrbConfig(NamedTuple):
    n_features: int = 1000
    n_levels: int = 8
    scale: float = 1.2
    fast_threshold: float = 20.0
    fast_min_threshold: float = 7.0
    cell: int = 16
    border: int = 19


def extract_orb(img: torch.Tensor, config: OrbConfig = OrbConfig()) -> OrbFeatures:
    """Full ORB pipeline for one grayscale float32 image (H, W); output
    capacity is config.n_features (padded with valid=False)."""
    pyr = image_ops.build_pyramid(img, config.n_levels, config.scale)
    counts = fast_ops.level_feature_counts(config.n_features, config.n_levels, config.scale)
    used = [(lvl, limg.contiguous(), n_l) for lvl, (limg, n_l) in enumerate(zip(pyr, counts)) if n_l > 0]
    # One kernel launch scores, suppresses and ranks every level (on the CPU:
    # the plain versions, level by level).
    cells = fast_ops.suppressed_cells_pyramid(
        [limg for _, limg, _ in used], cell=config.cell, border=config.border,
        threshold=config.fast_threshold, min_threshold=config.fast_min_threshold,
        min_stride=max(counts),
    )
    picked = fast_ops.select_from_pyramid_cells(cells, [n_l for _, _, n_l in used], config.cell)
    per_level = []
    for (lvl, limg, n_l), (yx, resp, valid) in zip(used, picked):
        raw = _gather_patches(limg, yx, half=GATHER_HALF)
        bpatches = blur_patches(raw, 3.0)
        ang = ic_angle(bpatches)
        packed, pm1 = brief_descriptors(bpatches, ang)
        xy0 = yx.flip(-1).to(torch.float32) * (config.scale**lvl)
        per_level.append(OrbFeatures(
            xy=xy0,
            level=torch.full((n_l,), lvl, dtype=torch.int32, device=img.device),
            angle=ang, response=resp, desc=packed, desc_pm1=pm1, valid=valid,
        ))
    return OrbFeatures(*(torch.cat(parts, dim=0) for parts in zip(*per_level)))
