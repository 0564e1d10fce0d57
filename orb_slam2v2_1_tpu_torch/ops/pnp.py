"""Batched RANSAC absolute pose (PnP) from 2D-3D correspondences.

Port of the JAX package's `ops/pnp.py` (the reference's EPnP + RANSAC
`PnPsolver`, src/PnPsolver.cc:165, used by relocalization): each hypothesis
solves the 6-point DLT for the projective matrix and projects it onto SE(3)
with the known intrinsics; the N_HYP hypotheses are scored in one batch with
the reference's scale-dependent reprojection test (`CheckInliers`,
src/PnPsolver.cc:308-337).

The reference draws the hypotheses' point sets with Gumbel noise from a JAX
key, a stream PyTorch cannot reproduce: `pnp_ransac` takes a
`torch.Generator` to draw its own, or the (N_HYP, 6) sets themselves, which
the parity tests take from the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie
from .topk import random_subsets

N_HYP = 256
SAMPLE = 6


class PnPResult(NamedTuple):
    success: torch.Tensor  # () bool
    Tcw: torch.Tensor  # (4,4)
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int32


def _dlt_pose(pw: torch.Tensor, uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., S, 3) world points + (..., S, 2) pixels -> (..., 4, 4) Tcw: the
    null vector of the 2S x 12 DLT system (the eigenvector of A^T A with the
    smallest eigenvalue, solved in float64), rows of R scaled to unit
    geometric-mean norm, the sign that puts the points in front, then SO(3)
    projection."""
    xn = (uv[..., 0] - K[2]) / K[0]
    yn = (uv[..., 1] - K[3]) / K[1]
    X, Y, Z = pw[..., 0], pw[..., 1], pw[..., 2]
    o = torch.ones_like(X)
    z = torch.zeros_like(X)
    r1 = torch.stack([X, Y, Z, o, z, z, z, z, -xn * X, -xn * Y, -xn * Z, -xn], -1)
    r2 = torch.stack([z, z, z, z, X, Y, Z, o, -yn * X, -yn * Y, -yn * Z, -yn], -1)
    A = torch.cat([r1, r2], dim=-2).double()  # (..., 2S, 12)
    # Float64 for the eigen solve: in float32 the null vector of A^T A
    # (condition number squared) is off by 1e-4 to 1e-2 m in translation on
    # ordinary six-point sets, in the reference as well, and two float32
    # solvers disagree by that much; in float64 it is the exact solution of
    # the float32 inputs, so the port sits at the reference's own error.
    _, evecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)  # ascending eigenvalues
    P = evecs[..., :, 0].reshape(evecs.shape[:-2] + (3, 4)).to(pw.dtype)
    scale = torch.exp(torch.mean(torch.log(torch.clamp(torch.linalg.norm(P[..., :3], dim=-1), min=1e-12)), -1))
    P = P / scale[..., None, None]
    depth = torch.sum(pw * P[..., None, 2, :3], -1) + P[..., 2, 3, None]
    P = P * torch.where(torch.mean(depth, -1) < 0, -1.0, 1.0)[..., None, None]
    return lie.make_se3(lie.project_so3(P[..., :3]), P[..., 3])


def sample_sets(valid: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """(N_HYP, SAMPLE) correspondence indices per hypothesis, distinct and
    valid where SAMPLE are valid."""
    return random_subsets(valid, N_HYP, SAMPLE, generator)


def hypothesis_inliers(T, pw, uv, inv_sigma2, valid, K, chi2_th: float = 5.991) -> torch.Tensor:
    """(H, N) inlier masks of H poses (H,4,4): valid, in front, and inside
    the octave-scaled reprojection gate."""
    pc = torch.einsum("hij,nj->hni", T[:, :3, :3], pw) + T[:, None, :3, 3]
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = K[0] * pc[..., 0] / z + K[2]
    v = K[1] * pc[..., 1] / z + K[3]
    e2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * inv_sigma2
    return valid & (e2 < chi2_th) & (pc[..., 2] > 0)


def pnp_ransac(pw: torch.Tensor, uv: torch.Tensor, inv_sigma2: torch.Tensor, valid: torch.Tensor,
               K: torch.Tensor, generator: torch.Generator | None = None, sets: torch.Tensor | None = None,
               chi2_th: float = 5.991) -> PnPResult:
    """Batched-hypothesis RANSAC over pw (N,3), uv (N,2), inv_sigma2 (N,)
    and valid (N,): N_HYP DLT poses scored at once, the first best wins.
    Give the hypothesis sets (N_HYP, SAMPLE) or a generator to draw them."""
    if sets is None:
        if generator is None:
            raise ValueError("pnp_ransac needs a torch.Generator or the hypothesis sets")
        sets = sample_sets(valid, generator)
    sets = sets.long()
    T = _dlt_pose(pw[sets], uv[sets], K)  # (H,4,4)
    inls = hypothesis_inliers(T, pw, uv, inv_sigma2, valid, K, chi2_th)
    scores = torch.sum(inls, dim=-1, dtype=torch.int32)
    best = torch.argmax(scores)
    n = scores[best]
    min_inliers = torch.clamp((0.1 * torch.sum(valid, dtype=torch.int32)).to(torch.int32), min=10)
    return PnPResult(success=n >= min_inliers, Tcw=T[best], inliers=inls[best], n_inliers=n)
