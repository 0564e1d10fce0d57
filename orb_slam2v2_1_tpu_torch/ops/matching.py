"""Feature matching: masked Hamming searches + rotation consistency.

Port of the JAX package's `ops/matching.py`. Every function takes optional
leading batch dimensions, which replace the reference's `vmap`s.

Kernel 2 (`csrc/masked_best_two.cu`) has two entry points here, and each
launches the kernel for CUDA tensors and runs its plain version for CPU
tensors, which the kernel equals exactly: `masked_best_two` (best, argmin and
second-best per query; plain: `best_two(distance_matrix, mask)`) and
`match_projection` (the same search ending in the distance and ratio tests
and the one-to-one resolution; plain: `match_projection_plain`).
Both take packed int32 descriptor words, the form every caller already holds.

Thresholds follow the reference: TH_HIGH=100, TH_LOW=50, 30 rotation bins.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import hamming
from .topk import stable_topk

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30

BIG = 1 << 20


class Matches(NamedTuple):
    idx: torch.Tensor  # (..., Q) int64 matched target index (undefined if !ok)
    dist: torch.Tensor  # (..., Q) int32 Hamming distance
    ok: torch.Tensor  # (..., Q) bool


def best_two(D: torch.Tensor, mask: torch.Tensor):
    """Row-wise best and second-best over a masked distance matrix.

    D: (..., Q, N) int32; mask: (..., Q, N) bool. Returns (best_idx int64,
    best int32, second int32); a row with no candidate gives idx 0 and
    best = second = 1 << 20."""
    Dm = torch.where(mask, D, torch.full_like(D, BIG))
    best_idx = torch.argmin(Dm, dim=-1)  # first minimal index on ties
    best = torch.gather(Dm, -1, best_idx[..., None])[..., 0]
    D2 = Dm.scatter(-1, best_idx[..., None], BIG)
    second = torch.amin(D2, dim=-1)
    return best_idx, best, second


def window_mask(qxy: torch.Tensor, txy: torch.Tensor, radius) -> torch.Tensor:
    """(..., Q, N) bool: target within +-radius box of the query's predicted
    position; radius is (..., Q) or a scalar."""
    dx = torch.abs(qxy[..., :, None, 0] - txy[..., None, :, 0])
    dy = torch.abs(qxy[..., :, None, 1] - txy[..., None, :, 1])
    r = torch.as_tensor(radius, dtype=torch.float32, device=qxy.device)
    r = r.expand(qxy.shape[:-1])[..., None]
    return (dx <= r) & (dy <= r)


def level_mask(pred_level: torch.Tensor, t_level: torch.Tensor, lo: int = -1, hi: int = 1):
    """(..., Q, N) bool: target octave within [pred+lo, pred+hi]."""
    d = t_level[..., None, :] - pred_level[..., :, None]
    return (d >= lo) & (d <= hi)


def rotation_consistency(dangle: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Keep only matches whose angle delta falls in the 3 most popular of 30
    bins (ORBmatcher::ComputeThreeMaxima). dangle, ok: (..., Q)."""
    deg = torch.fmod(dangle * (180.0 / math.pi), 360.0)
    deg = torch.where(deg < 0, deg + 360.0, deg)
    bins = torch.clamp((deg * (HISTO_LENGTH / 360.0)).to(torch.int32), 0, HISTO_LENGTH - 1).long()
    hist = torch.zeros(ok.shape[:-1] + (HISTO_LENGTH,), dtype=torch.int32, device=ok.device)
    hist = hist.scatter_add(-1, bins, ok.to(torch.int32))
    vals, top_bins = stable_topk(hist, 3)
    keep = (vals >= 0.1 * vals[..., :1]) & (vals > 0)
    good_bins = torch.zeros_like(hist, dtype=torch.bool).scatter(-1, top_bins, keep)
    return ok & torch.gather(good_bins, -1, bins)


def resolve_duplicates(idx: torch.Tensor, dist: torch.Tensor, ok: torch.Tensor, n_targets: int):
    """One-to-one enforcement: per target keep the best distance, ties to the
    first query."""
    idx = idx.long()
    tgt = torch.where(ok, idx, torch.full_like(idx, n_targets))
    shape = ok.shape[:-1] + (n_targets + 1,)
    best_per_tgt = torch.full(shape, BIG, dtype=dist.dtype, device=dist.device)
    best_per_tgt = best_per_tgt.scatter_reduce(-1, tgt, dist, reduce="amin")
    winner = ok & (dist <= torch.gather(best_per_tgt, -1, tgt))
    qidx = torch.arange(idx.shape[-1], dtype=torch.int64, device=idx.device).expand_as(idx)
    first_q = torch.full(shape, 1 << 30, dtype=torch.int64, device=idx.device)
    first_q = first_q.scatter_reduce(
        -1, torch.where(winner, tgt, torch.full_like(tgt, n_targets)), qidx, reduce="amin"
    )
    winner = winner & (torch.gather(first_q, -1, tgt) == qidx)
    return Matches(idx=idx, dist=dist, ok=winner)


def _ratio_ok(best, second, max_dist, nn_ratio):
    return (best <= max_dist) & (best.to(torch.float32) <= nn_ratio * second.to(torch.float32))


def match_nn(q_desc: torch.Tensor, t_desc: torch.Tensor, mask: torch.Tensor,
             max_dist: int = TH_LOW, nn_ratio: float = 1.0) -> Matches:
    """Generic masked nearest neighbour with Lowe ratio, on +-1 descriptors
    (..., Q, 256) x (..., N, 256) and an arbitrary (..., Q, N) mask."""
    D = hamming.distance_matrix(q_desc, t_desc)
    best_idx, best, second = best_two(D, mask)
    return Matches(idx=best_idx, dist=best, ok=_ratio_ok(best, second, max_dist, nn_ratio))


def match_mutual(a_desc: torch.Tensor, b_desc: torch.Tensor, mask: torch.Tensor,
                 max_dist: int = TH_LOW, nn_ratio: float = 0.9) -> Matches:
    """Mutual-best masked nearest neighbour a -> b on +-1 descriptors, with
    the distance and ratio tests (`SearchForInitialization`,
    src/ORBmatcher.cc:405-520)."""
    D = hamming.distance_matrix(a_desc, b_desc)
    a_best_idx, a_best, a_second = best_two(D, mask)
    b_best_idx = torch.argmin(torch.where(mask, D, torch.full_like(D, BIG)), dim=-2)
    q = torch.arange(a_desc.shape[-2], device=a_desc.device)
    mutual = torch.gather(b_best_idx, -1, a_best_idx) == q
    return Matches(idx=a_best_idx, dist=a_best, ok=_ratio_ok(a_best, a_second, max_dist, nn_ratio) & mutual)


def masked_best_two_plain(q_words, q_xy, q_level, q_valid, radius,
                          t_words, t_xy, t_level, t_valid, level_lo=-1, level_hi=1):
    """Plain version of kernel 2: `best_two(distance_matrix, window & level &
    valid)` on packed words (..., Q, 8) / (..., N, 8)."""
    mask = (
        window_mask(q_xy, t_xy, radius)
        & level_mask(q_level, t_level, level_lo, level_hi)
        & q_valid[..., :, None]
        & t_valid[..., None, :]
    )
    D = hamming.distance_matrix(hamming.unpack_pm1(q_words), hamming.unpack_pm1(t_words))
    return best_two(D, mask)


def _search_batch(q_words, q_xy, q_level, q_valid, radius, t_words, t_xy, t_level, t_valid):
    """The kernels' (B, Q, ..) / (B, N, ..) views of a search's inputs and
    the leading shape. Inputs of the right type and layout are only viewed;
    a scalar or broadcast radius, and any input expanded over the batch (the
    same queries for every target set), is materialized."""
    lead = q_words.shape[:-2]
    Q, N = q_words.shape[-2], t_words.shape[-2]
    if not (torch.is_tensor(radius) and radius.shape == lead + (Q,) and radius.dtype == torch.float32):
        radius = torch.as_tensor(radius, dtype=torch.float32, device=q_words.device).expand(lead + (Q,))
    shaped = [x.reshape((-1,) + tail).contiguous() for x, tail in (
        (q_words, (Q, 8)), (q_xy, (Q, 2)), (q_level, (Q,)), (q_valid, (Q,)), (radius, (Q,)),
        (t_words, (N, 8)), (t_xy, (N, 2)), (t_level, (N,)), (t_valid, (N,)))]
    return shaped, lead + (Q,)


def masked_best_two(q_words, q_xy, q_level, q_valid, radius,
                    t_words, t_xy, t_level, t_valid, level_lo=-1, level_hi=1):
    """Fused SearchByProjection reduction -> (best_idx int64, best int32,
    second int32), each (..., Q): kernel 2 (best-two form) on CUDA tensors,
    the plain version on CPU tensors."""
    if not q_words.is_cuda:
        return masked_best_two_plain(q_words, q_xy, q_level, q_valid, radius,
                                     t_words, t_xy, t_level, t_valid, level_lo, level_hi)
    from .. import kernels

    shaped, out_shape = _search_batch(q_words, q_xy, q_level, q_valid, radius,
                                      t_words, t_xy, t_level, t_valid)
    return tuple(o.view(out_shape) for o in kernels.masked_best_two(*shaped, level_lo, level_hi))


def match_projection_plain(
    q_words, q_xy_pred, q_level_pred, q_valid,
    t_words, t_xy, t_level, t_valid, radius,
    max_dist: int = TH_HIGH, nn_ratio: float = 0.9, level_lo: int = -1, level_hi: int = 1,
) -> Matches:
    """Plain version of kernel 2's match form: `resolve_duplicates` over
    `_ratio_ok` over `masked_best_two_plain`."""
    best_idx, best, second = masked_best_two_plain(
        q_words, q_xy_pred, q_level_pred, q_valid, radius,
        t_words, t_xy, t_level, t_valid, level_lo, level_hi,
    )
    ok = _ratio_ok(best, second, max_dist, nn_ratio)
    return resolve_duplicates(best_idx, best, ok, t_words.shape[-2])


def match_projection(
    q_words, q_xy_pred, q_level_pred, q_valid,
    t_words, t_xy, t_level, t_valid, radius,
    max_dist: int = TH_HIGH, nn_ratio: float = 0.9, level_lo: int = -1, level_hi: int = 1,
) -> Matches:
    """SearchByProjection analog (map points -> frame keypoints) over packed
    descriptor words, with optional leading batch dimensions: the search, the
    distance and ratio tests and the one-to-one resolution. Kernel 2 (match
    form) on CUDA tensors, `match_projection_plain` on CPU tensors."""
    if not q_words.is_cuda:
        return match_projection_plain(q_words, q_xy_pred, q_level_pred, q_valid,
                                      t_words, t_xy, t_level, t_valid, radius,
                                      max_dist, nn_ratio, level_lo, level_hi)
    from .. import kernels

    shaped, out_shape = _search_batch(q_words, q_xy_pred, q_level_pred, q_valid, radius,
                                      t_words, t_xy, t_level, t_valid)
    idx, dist, ok = kernels.masked_match(*shaped, level_lo, level_hi, max_dist, nn_ratio)
    return Matches(idx=idx.view(out_shape), dist=dist.view(out_shape), ok=ok.view(out_shape))
