"""A plain ORB extractor: the frozen reference for the keypoints and
descriptors that the program's frame build produces.

A copy of the plain versions of the SLAM port's ORB (`ops/image.py`'s
pyramid, `ops/fast.py`'s FAST-9/16 score, 3x3 suppression and per-cell
selection, `ops/orb.py`'s patches, blur, intensity-centroid angle and
angle-binned steered BRIEF), written for one image at a time with no kernel
and no batching across levels. It imports nothing of the program. Matrix
products and convolutions run in float32 (TF32 off).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HALF_PATCH = 15
PATCH = 2 * HALF_PATCH + 1
PATTERN_RADIUS = 13
N_ANGLE_BINS = 32
BLUR_SIZE = 9
GATHER_HALF = HALF_PATCH + BLUR_SIZE // 2
CELL = 16
BORDER = 19
CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


class Keypoints(NamedTuple):
    xy: torch.Tensor  # (N, 2) float32 level-0 pixel coordinates (x, y)
    level: torch.Tensor  # (N,) int64
    valid: torch.Tensor  # (N,) bool
    bits: torch.Tensor  # (N, 256) bool BRIEF bits


def brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 4) int (ay, ax, by, bx) tap pairs, Gaussian within radius 13."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < 512:
        p = rng.normal(0.0, PATCH / 5.0, size=2)
        if np.linalg.norm(p) <= PATTERN_RADIUS:
            pts.append(p)
    pts = np.round(np.asarray(pts)).astype(np.int64)
    return np.concatenate([pts[0::2], pts[1::2]], axis=1)


def tap_index(pattern: np.ndarray) -> np.ndarray:
    """(N_ANGLE_BINS, 512) flat patch index of each a-tap then b-tap, the
    pattern rotated to each bin's centre angle and rounded."""
    out = np.zeros((N_ANGLE_BINS, 512), np.int64)
    ay, ax, by, bx = pattern.T.astype(np.float64)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        for y, x, col in ((ay, ax, 0), (by, bx, 256)):
            ry = np.round(sa * x + ca * y).astype(np.int64) + HALF_PATCH
            rx = np.round(ca * x - sa * y).astype(np.int64) + HALF_PATCH
            out[b, col:col + 256] = ry * PATCH + rx
    return out


TAPS = tap_index(brief_pattern())


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 antialiased triangle-filter weights of a
    bilinear downscale (jax.image.resize's weight matrix)."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def level_counts(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Keypoints per level, geometric in 1/scale, the rest on the last."""
    f = 1.0 / scale
    base = n_features / ((1.0 - f**n_levels) / (1.0 - f))
    counts = [int(round(base * f**l)) for l in range(n_levels - 1)]
    return counts + [max(n_features - sum(counts), 0)]


def pyramid(img: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    h, w = img.shape
    out = [img]
    for l in range(1, n_levels):
        s = 1.0 / (scale**l)
        lh, lw = int(round(h * s)), int(round(w * s))
        wy = torch.from_numpy(resize_weights(h, lh)).to(img.device)
        wx = torch.from_numpy(resize_weights(w, lw)).to(img.device)
        out.append(wy.T @ img @ wx)
    return out


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """The largest t with 9 contiguous circle pixels all brighter than p + t
    or all darker than p - t, clipped at 0; edge pixels repeat outward."""
    h, w = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    d = torch.stack([p[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] for dy, dx in CIRCLE]) - img

    def min9(x):
        w2 = torch.minimum(x, torch.roll(x, -1, 0))
        w4 = torch.minimum(w2, torch.roll(w2, -2, 0))
        w8 = torch.minimum(w4, torch.roll(w4, -4, 0))
        return torch.minimum(w8, torch.roll(x, -8, 0))

    return torch.clamp(torch.maximum(torch.amax(min9(d), 0), torch.amax(min9(-d), 0)), min=0.0)


def level_keypoints(img: torch.Tensor, n: int, threshold: float, min_threshold: float):
    """The best corner of each 16x16 cell, the strongest n cells (ties to
    the lower cell): (yx (n, 2) int64, valid (n,) bool)."""
    s = fast_score(img)
    s = torch.where(s >= F.max_pool2d(s[None, None], 3, stride=1, padding=1)[0, 0], s, 0.0)
    h, w = s.shape
    ys = torch.arange(h, device=s.device)[:, None]
    xs = torch.arange(w, device=s.device)[None, :]
    inside = (ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER) & (xs < w - BORDER)
    s = torch.where(inside & (s >= min_threshold), s, 0.0)
    rank = torch.where(s > 0.0, torch.where(s >= threshold, s + 1e4, s), 0.0)
    rp = F.pad(rank, (0, -w % CELL, 0, -h % CELL))
    ch, cw = rp.shape[0] // CELL, rp.shape[1] // CELL
    tiles = rp.reshape(ch, CELL, cw, CELL).permute(0, 2, 1, 3).reshape(ch * cw, CELL * CELL)
    best, arg = torch.amax(tiles, -1), torch.argmax(tiles, -1)
    if best.numel() < n:
        best = F.pad(best, (0, n - best.numel()))
        arg = F.pad(arg, (0, n - arg.numel()))
    vals, cell = torch.sort(best, descending=True, stable=True)
    vals, cell = vals[:n], cell[:n]
    a = arg[torch.clamp(cell, max=ch * cw - 1)]
    yx = torch.stack([cell // cw * CELL + a // CELL, cell % cw * CELL + a % CELL], -1)
    return yx, vals > 0.0


def patches(img: torch.Tensor, yx: torch.Tensor, half: int) -> torch.Tensor:
    """(K, 2h+1, 2h+1) windows centred at yx, each start clamped so that the
    window lies inside the image."""
    H, W = img.shape
    size = 2 * half + 1
    y0 = torch.clamp(yx[:, 0] - half, 0, H - size)
    x0 = torch.clamp(yx[:, 1] - half, 0, W - size)
    r = torch.arange(size, device=img.device)
    return img[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]


def describe(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool steered-BRIEF bits at yx on one pyramid level."""
    dev = img.device
    x = torch.arange(BLUR_SIZE, dtype=torch.float32, device=dev) - (BLUR_SIZE - 1) / 2.0
    g = torch.exp(-0.5 * (x / 3.0) ** 2)
    g = g / torch.sum(g)
    p = patches(img, yx, GATHER_HALF)[:, None]
    p = F.conv2d(F.conv2d(p, g.view(1, 1, 1, BLUR_SIZE)), g.view(1, 1, BLUR_SIZE, 1))[:, 0]
    r = torch.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=torch.float32, device=dev)
    disc = ((r[:, None] ** 2 + r[None, :] ** 2) <= HALF_PATCH**2).to(torch.float32)
    wgt = p * disc
    angle = torch.atan2(torch.sum(wgt * r[None, :, None], dim=(1, 2)), torch.sum(wgt * r[None, None, :], dim=(1, 2)))
    b = torch.remainder(torch.round(angle / (2.0 * math.pi) * N_ANGLE_BINS).to(torch.int64), N_ANGLE_BINS)
    sel = torch.gather(p.reshape(p.shape[0], -1), 1, torch.from_numpy(TAPS).to(dev)[b])
    return sel[:, :256] < sel[:, 256:]


def extract(img: torch.Tensor, n_features: int, n_levels: int, scale: float, threshold: float = 20.0,
            min_threshold: float = 7.0) -> Keypoints:
    """ORB keypoints of one float32 image (H, W), level by level in the
    order of their budgets, padded to n_features with valid False."""
    xy, lv, ok, bits = [], [], [], []
    for l, (limg, n) in enumerate(zip(pyramid(img, n_levels, scale), level_counts(n_features, n_levels, scale))):
        if n == 0:
            continue
        yx, valid = level_keypoints(limg, n, threshold, min_threshold)
        xy.append(yx.flip(-1).to(torch.float32) * (scale**l))
        lv.append(torch.full((n,), l, dtype=torch.int64, device=img.device))
        ok.append(valid)
        bits.append(describe(limg, yx))
    return Keypoints(*(torch.cat(x) for x in (xy, lv, ok, bits)))
