"""FAST-9/16 corner scoring + spread-constrained keypoint selection.

Port of the JAX package's `ops/fast.py`. The whole level is scored in one
vectorized pass, non-max suppressed with a 3x3 max, then distributed by
keeping the best corner of each `cell x cell` tile and taking the strongest
`n` tiles.

Kernel 1 (`csrc/fast_score_nms.cu`) has two entry points here, and each
launches the kernel for CUDA tensors and runs its plain version for CPU
tensors, which the kernel equals bit for bit: `suppressed_score` (one level
-> `nms3(fast_score(img))`) and `suppressed_cells_pyramid` (all levels in one
launch -> `rank_cells` of each level's suppressed score). `select_keypoints`
is `rank_cells`, the part that the kernel's epilogue does on the card, followed
by `select_from_cells`, the part that stays in PyTorch;
`select_from_pyramid_cells` is the latter for all levels at once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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
    """`nms3(fast_score(img))`: kernel 1 (map form) for a CUDA tensor, the
    plain version for a CPU tensor."""
    if img.is_cuda:
        from .. import kernels

        return kernels.fast_score_nms(img)
    return nms3(fast_score(img))


def rank_cells(s: torch.Tensor, cell: int = 16, border: int = 19, threshold: float = 20.0,
               min_threshold: float = 7.0):
    """Suppressed score (H, W) -> the best corner of each `cell x cell` cell:
    (cell_best (ch, cw) float32, cell_arg (ch, cw) int64). Scores inside the
    border or under `min_threshold` rank 0, scores at or over `threshold`
    rank 1e4 higher, the ragged edge is padded with 0, and `cell_arg` is the
    row-major index within the cell of its first maximal entry (0 for an
    empty cell). The plain version of kernel 1's cell-form epilogue."""
    h, w = s.shape
    dev = s.device
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
    return torch.amax(tiles, dim=-1), torch.argmax(tiles, dim=-1)  # first maximal index, as jnp.argmax


class PyramidCells(NamedTuple):
    """`rank_cells` of every level of a pyramid, one padded row per level."""

    best: torch.Tensor  # (L, S) float32: level l's cells, row-major, then zeros
    arg: torch.Tensor  # (L, S) int64: their argmax; undefined past the level's cells
    grids: tuple  # per level (ch, cw)

    def level(self, l: int):
        """(cell_best (ch, cw), cell_arg (ch, cw)) of level l, as `rank_cells`."""
        ch, cw = self.grids[l]
        return self.best[l, : ch * cw].view(ch, cw), self.arg[l, : ch * cw].view(ch, cw)


def suppressed_cells_pyramid(levels, cell: int = 16, border: int = 19, threshold: float = 20.0,
                             min_threshold: float = 7.0, min_stride: int = 0) -> PyramidCells:
    """`rank_cells(nms3(fast_score(level)), ...)` of every level, with rows
    of S = max(largest level's cells, min_stride): kernel 1 (cell form), one
    launch for the whole pyramid, for CUDA tensors; the plain versions level
    by level for CPU tensors."""
    if levels[0].is_cuda:
        from .. import kernels

        best, arg, grids = kernels.fast_cells_pyramid(levels, cell, border, threshold, min_threshold, min_stride)
        return PyramidCells(best, arg, tuple(grids))
    per_level = [rank_cells(nms3(fast_score(lvl)), cell, border, threshold, min_threshold) for lvl in levels]
    stride = max(max(b.numel() for b, _ in per_level), min_stride)
    best = torch.zeros((len(levels), stride), dtype=torch.float32)
    arg = torch.zeros((len(levels), stride), dtype=torch.int64)
    for l, (b, a) in enumerate(per_level):
        best[l, : b.numel()] = b.reshape(-1)
        arg[l, : a.numel()] = a.reshape(-1)
    return PyramidCells(best, arg, tuple(tuple(b.shape) for b, _ in per_level))


@functools.lru_cache(maxsize=16)
def _grid_constants(grids: tuple, device: torch.device):
    """(cw (L, 1), last cell index (L, 1)) of a pyramid's cell grids, int64."""
    cw = torch.tensor([[g[1]] for g in grids], dtype=torch.int64, device=device)
    last = torch.tensor([[g[0] * g[1] - 1] for g in grids], dtype=torch.int64, device=device)
    return cw, last


def select_from_pyramid_cells(cells: PyramidCells, counts, cell: int = 16):
    """Per level the strongest counts[l] cells as keypoints, a list of
    (yx (n, 2) int32, response (n,) float32, valid (n,) bool), with one sort
    and one pass of index arithmetic for the whole pyramid. Ties go to the
    lower cell index, as `jax.lax.top_k`. Needs rows of at least max(counts);
    a level with fewer cells than its count gets padding with valid False."""
    n_max = max(counts)
    if cells.best.shape[1] < n_max:
        raise ValueError(f"cells: rows of {cells.best.shape[1]} cannot hold {n_max} keypoints")
    cw, last = _grid_constants(cells.grids, cells.best.device)
    top_vals, top_idx = stable_topk(cells.best, n_max)  # zeros past a level's cells sort last
    arg = torch.gather(cells.arg, 1, torch.minimum(top_idx, last))
    yx = torch.stack([top_idx // cw * cell + arg // cell, top_idx % cw * cell + arg % cell], dim=-1)
    yx = yx.to(torch.int32)
    valid = top_vals > 0.0
    resp = torch.where(top_vals >= 1e4, top_vals - 1e4, top_vals)
    return [(yx[l, :n], resp[l, :n], valid[l, :n]) for l, n in enumerate(counts)]


def select_from_cells(cell_best: torch.Tensor, cell_arg: torch.Tensor, n: int, cell: int = 16):
    """The strongest `n` cells of `rank_cells`' output as keypoints:
    (yx (n, 2) int32, response (n,) float32, valid (n,) bool). With fewer
    than n cells the rest is padding with valid False."""
    flat = cell_best.reshape(1, -1)
    if flat.shape[1] < n:
        flat = F.pad(flat, (0, n - flat.shape[1]))
    cells = PyramidCells(flat, cell_arg.reshape(1, -1), (tuple(cell_best.shape),))
    return select_from_pyramid_cells(cells, [n], cell)[0]


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
    s = nms3(score) if suppress else score
    cell_best, cell_arg = rank_cells(s, cell, border, threshold, min_threshold)
    return select_from_cells(cell_best, cell_arg, n, cell)


def level_feature_counts(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Per-level keypoint budget, geometric in 1/scale (Python ints)."""
    factor = 1.0 / scale
    total = (1.0 - factor**n_levels) / (1.0 - factor)
    base = n_features / total
    counts = [int(round(base * factor**l)) for l in range(n_levels - 1)]
    counts.append(max(n_features - sum(counts), 0))
    return counts
