"""Stereo keypoint matching: rectified row search + SAD subpixel refinement.

Port of the JAX package's `ops/stereo.py` (`Frame::ComputeStereoMatches`,
src/Frame.cc:481-655): for each left keypoint the best right keypoint in the
same rectified row band by Hamming distance (one masked distance matrix; the
reference computes it outside its Pallas kernels, so it stays plain PyTorch
here), then the disparity refined by sliding an 11x11 SAD window +-5 px and
fitting a parabola to the minimum. All keypoints are refined at once: their
11x21 strips are cut in one gather.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import matching
from .image import gather_windows

SAD_W = 5  # 11x11 window
SAD_L = 5  # +-5 px sliding range


def match_stereo(left_xy, left_level, left_pm1, left_valid, right_xy, right_level, right_pm1, right_valid,
                 bf, fx, min_z):
    """Returns (ur (N,), depth (N,), ok (N,)), -1 where unmatched.

    Row band: +-2 * scale^level_r (the reference's vRowIndices construction,
    src/Frame.cc:499-513). Disparity in [-3, bf/min_z]."""
    scale_r = torch.pow(1.2, right_level.to(torch.float32))
    dy = torch.abs(left_xy[:, None, 1] - right_xy[None, :, 1])
    row_ok = dy <= 2.0 * scale_r[None, :]
    disp = left_xy[:, None, 0] - right_xy[None, :, 0]
    max_d = bf / torch.clamp(torch.as_tensor(min_z, dtype=torch.float32), min=1e-6)
    disp_ok = (disp >= -3.0) & (disp <= max_d)
    level_ok = torch.abs(left_level[:, None] - right_level[None, :]) <= 1
    mask = row_ok & disp_ok & level_ok & left_valid[:, None] & right_valid[None, :]

    m = matching.match_nn(left_pm1, right_pm1, mask, max_dist=matching.TH_HIGH, nn_ratio=1.0)
    ur0 = right_xy[m.idx, 0]
    disparity = torch.clamp(left_xy[:, 0] - ur0, min=0.01)
    ok = m.ok & (disparity > 0)
    return torch.where(ok, ur0, -1.0), torch.where(ok, bf / disparity, -1.0), ok


def sad_subpixel_refine(left_img, right_img, left_xy, ur, ok, bf):
    """SAD refinement (src/Frame.cc:556-639) of every keypoint, matched or
    not (an unmatched one carries ur = -1 and comes out -1): the 11x11 left
    window against 11 shifts of the right one in an 11x21 strip, both cut
    from edge-padded images with `lax.dynamic_slice`'s clamped starts, and a
    parabola through the minimum. Returns (ur, depth)."""
    pad = SAD_W + SAD_L + 1
    size = 2 * SAD_W + 1
    li = F.pad(left_img[None, None], (pad,) * 4, mode="replicate")[0, 0]
    ri = F.pad(right_img[None, None], (pad,) * 4, mode="replicate")[0, 0]
    x0 = torch.round(left_xy[:, 0]).to(torch.int32) + pad
    y0 = torch.round(left_xy[:, 1]).to(torch.int32) + pad
    ur0 = torch.round(ur).to(torch.int32) + pad

    lw = gather_windows(li, y0 - SAD_W, x0 - SAD_W, size, size)  # (N,11,11)
    lw = lw - lw[:, SAD_W, SAD_W, None, None]
    strip = gather_windows(ri, y0 - SAD_W, ur0 - SAD_W - SAD_L, size, size + 2 * SAD_L)  # (N,11,21)
    rw = strip.unfold(2, size, 1).permute(0, 2, 1, 3)  # (N,11 shifts,11,11)
    rw = rw - rw[:, :, SAD_W, SAD_W, None, None]
    dists = torch.sum(torch.abs(lw[:, None] - rw), dim=(-2, -1))  # (N,11)

    best = torch.argmin(dists, dim=-1)  # the first minimum
    interior = (best > 0) & (best < 2 * SAD_L)
    bl = torch.clamp(best, 1, 2 * SAD_L - 1)
    d1, d2, d3 = (torch.gather(dists, 1, (bl + o)[:, None])[:, 0] for o in (-1, 0, 1))
    delta = torch.where(interior, (d1 - d3) / torch.clamp(2.0 * (d1 + d3 - 2.0 * d2), min=1e-6), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    ur_ref = ur + (bl.to(torch.float32) - SAD_L) + delta
    disparity = torch.clamp(left_xy[:, 0] - ur_ref, min=0.01)
    return torch.where(ok, ur_ref, -1.0), torch.where(ok, bf / disparity, -1.0)
