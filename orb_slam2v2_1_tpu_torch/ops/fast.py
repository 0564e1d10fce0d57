"""FAST-9/16 corner scoring + spread-constrained keypoint selection.

Port of the JAX package's `ops/fast.py`. The whole level is scored in one
vectorized pass, non-max suppressed with a 3x3 max, then distributed by
keeping the best corner of each `cell x cell` tile and taking the strongest
`n` tiles.

`suppressed_score` is the entry point of kernel 1 (`csrc/fast_score_nms.cu`):
on a CUDA tensor it launches the kernel, on a CPU tensor it runs the plain
version `nms3(fast_score(img))`, which the kernel equals bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .topk import stable_topk

# Bresenham circle of radius 3, in circular order: (dy, dx).
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _min9(x: torch.Tensor) -> torch.Tensor:
    """Min over each circular window of 9 consecutive entries along axis 0."""
    w2 = torch.minimum(x, torch.roll(x, -1, 0))
    w4 = torch.minimum(w2, torch.roll(w2, -2, 0))
    w8 = torch.minimum(w4, torch.roll(w4, -4, 0))
    return torch.minimum(w8, torch.roll(x, -8, 0))


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """FAST-9/16 corner score per pixel: the largest margin `t` such that 9
    contiguous circle pixels are all brighter than p+t (or all darker than
    p-t), clipped at 0. Circle reads outside the image take the nearest edge
    pixel. (H, W) float32 -> (H, W) float32."""
    h, w = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    d = torch.stack([p[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] for dy, dx in _CIRCLE]) - img
    bright = torch.amax(_min9(d), dim=0)
    dark = torch.amax(_min9(-d), dim=0)
    return torch.clamp(torch.maximum(bright, dark), min=0.0)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression (-inf outside the image): keep the score only
    where it is >= its neighbourhood max."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, torch.zeros_like(score))


def suppressed_score(img: torch.Tensor) -> torch.Tensor:
    """`nms3(fast_score(img))`: kernel 1 for a CUDA tensor, the plain
    version for a CPU tensor."""
    if img.is_cuda:
        from .. import kernels

        return kernels.fast_score_nms(img)
    return nms3(fast_score(img))


def select_keypoints(
    score: torch.Tensor,
    n: int,
    cell: int = 16,
    border: int = 19,
    threshold: float = 20.0,
    min_threshold: float = 7.0,
    suppress: bool = True,
):
    """Pick <= n spread-out corners: best corner per cell, strongest cells win.

    Returns (yx (n, 2) int32, response (n,) float32, valid (n,) bool).
    Corners >= `threshold` outrank weak ones, which only fill empty cells.
    """
    h, w = score.shape
    dev = score.device
    s = nms3(score) if suppress else score
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    in_border = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    zero = torch.zeros_like(s)
    s = torch.where(in_border & (s >= min_threshold), s, zero)
    rank = torch.where(s >= threshold, s + 1e4, s)
    rank = torch.where(s > 0.0, rank, zero)

    ph = -h % cell
    pw = -w % cell
    rp = F.pad(rank, (0, pw, 0, ph))
    ch, cw = rp.shape[0] // cell, rp.shape[1] // cell
    tiles = rp.reshape(ch, cell, cw, cell).permute(0, 2, 1, 3).reshape(ch, cw, cell * cell)
    cell_best = torch.amax(tiles, dim=-1)
    cell_arg = torch.argmax(tiles, dim=-1)  # first maximal index, as jnp.argmax

    flat = cell_best.reshape(-1)
    if flat.shape[0] < n:
        flat = F.pad(flat, (0, n - flat.shape[0]))
    top_vals, top_idx = stable_topk(flat, n)
    cy = top_idx // cw
    cx = top_idx % cw
    arg = cell_arg.reshape(-1)[top_idx.clamp(max=cell_arg.numel() - 1)]
    yx = torch.stack([cy * cell + arg // cell, cx * cell + arg % cell], dim=-1).to(torch.int32)
    valid = top_vals > 0.0
    resp = torch.where(top_vals >= 1e4, top_vals - 1e4, top_vals)
    return yx, resp, valid


def level_feature_counts(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Per-level keypoint budget, geometric in 1/scale (Python ints)."""
    factor = 1.0 / scale
    total = (1.0 - factor**n_levels) / (1.0 - factor)
    base = n_features / total
    counts = [int(round(base * factor**l)) for l in range(n_levels - 1)]
    counts.append(max(n_features - sum(counts), 0))
    return counts
