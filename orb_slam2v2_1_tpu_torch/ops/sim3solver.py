"""Batched Horn closed-form Sim(3) estimation + RANSAC + LM refinement.

Port of the JAX package's `ops/sim3solver.py` (the analog of `Sim3Solver`
and `Optimizer::OptimizeSim3`): Horn's quaternion absolute orientation run as
N_HYP hypotheses of 3 correspondences each in one batch, with the mutual
reprojection inlier check. Scale is fixed to 1 for stereo/RGB-D.

The reference draws its hypothesis sets from a JAX random key; that stream
cannot be reproduced here, so `sim3_ransac` takes a `torch.Generator`
(Gumbel top-3 per hypothesis, as the reference) or the (N_HYP, 3) index sets
themselves.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie
from .topk import random_subsets

N_HYP = 256
CHI2_SIM3 = 9.210  # 2-dof 99% gate, both directions


class Sim3Result(NamedTuple):
    success: torch.Tensor
    S12: torch.Tensor  # (4,4) Sim3 mapping cam2 coords -> cam1 coords
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor


def _horn_rotation(M: torch.Tensor) -> torch.Tensor:
    """Rotation (.., 3, 3) of Horn's method from the correlation matrix M
    (.., 3, 3): the eigenvector of the largest eigenvalue of the 4x4 N
    matrix, as a quaternion (w, x, y, z)."""
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        dim=-2,
    )
    _, evecs = torch.linalg.eigh(N)
    q = evecs[..., :, -1]
    return lie.quat_to_rot(torch.stack([q[..., 1], q[..., 2], q[..., 3], q[..., 0]], -1))


def _weighted_horn(p1, p2, w, fix_scale: bool) -> torch.Tensor:
    """Horn's Sim3 with per-point weights w (.., S) on (.., S, 3) sets."""
    ww = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    c1 = torch.sum(p1 * ww[..., None], dim=-2)
    c2 = torch.sum(p2 * ww[..., None], dim=-2)
    d1 = p1 - c1[..., None, :]
    d2 = p2 - c2[..., None, :]
    q1 = d1 * w[..., None]
    q2 = d2 * w[..., None]
    R = _horn_rotation(q2.transpose(-1, -2) @ q1)
    if fix_scale:
        s = torch.ones_like(c1[..., 0])
    else:
        num = torch.sum((d2 @ R.transpose(-1, -2)) * d1 * w[..., None], dim=(-1, -2))
        den = torch.sum(d2 * d2 * w[..., None], dim=(-1, -2))
        s = num / torch.clamp(den, min=1e-12)
    t = c1 - s[..., None] * (R @ c2[..., None])[..., 0]
    return lie.make_sim3(R, t, s)


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool) -> torch.Tensor:
    """Closed-form Sim3 from matched 3-D sets (.., S, 3), (.., S, 3):
    p1 ~ S12 * p2."""
    return _weighted_horn(p1, p2, torch.ones_like(p1[..., 0]), fix_scale)


def _project(pc, K):
    z = torch.clamp(pc[..., 2], min=1e-6)
    return torch.stack([K[0] * pc[..., 0] / z + K[2], K[1] * pc[..., 1] / z + K[3]], -1)


def _apply(S, p):
    """Sim3 (.., 4, 4) applied to points (N, 3) -> (.., N, 3)."""
    return p @ S[..., :3, :3].transpose(-1, -2) + S[..., None, :3, 3]


def _reproj(S12, p1_cam, p2_cam, uv1, uv2, K):
    """Both-direction reprojection errors (.., N, 2) each."""
    S21 = lie.sim3_inverse(S12)
    return _project(_apply(S12, p2_cam), K) - uv1, _project(_apply(S21, p1_cam), K) - uv2


def hypothesis_sets(valid: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """(N_HYP, 3) indices of 3 distinct valid correspondences per
    hypothesis: the top 3 of Gumbel noise over the valid ones."""
    return random_subsets(valid, N_HYP, 3, generator)


def sim3_ransac(p1_cam, p2_cam, uv1, uv2, sigma2_1, sigma2_2, valid, K,
                generator: torch.Generator | None = None, sets: torch.Tensor | None = None,
                fix_scale: bool = True) -> Sim3Result:
    """RANSAC over N_HYP Horn hypotheses with the reference's thresholds:
    chi2 9.210 (2 dof, 99%) on both reprojections, a refit on the consensus
    set, success at >= 20 inliers. p*_cam (N,3) matched points in each camera
    frame, uv* (N,2) observed pixels, sigma2_* (N,) level variances. Give the
    hypothesis index sets (N_HYP, 3) or a generator to draw them from."""
    if sets is None:
        if generator is None:
            raise ValueError("sim3_ransac needs a torch.Generator or the hypothesis sets")
        sets = hypothesis_sets(valid, generator)
    sets = sets.long()

    def inliers_of(S12):
        e1, e2 = _reproj(S12, p1_cam, p2_cam, uv1, uv2, K)
        c1 = torch.sum(e1 * e1, -1) / sigma2_1
        c2 = torch.sum(e2 * e2, -1) / sigma2_2
        return valid & (c1 < CHI2_SIM3) & (c2 < CHI2_SIM3)

    Ss = horn_sim3(p1_cam[sets], p2_cam[sets], fix_scale)  # (H,4,4)
    inls = inliers_of(Ss)  # (H,N)
    scores = torch.sum(inls, dim=-1, dtype=torch.int32)
    best = torch.argmax(scores)
    n = scores[best]

    # Refit on the consensus set (LO step) with masked Horn.
    S_ref = _weighted_horn(p1_cam, p2_cam, inls[best].to(torch.float32), fix_scale)
    inl_r = inliers_of(S_ref)
    n_r = torch.sum(inl_r, dtype=torch.int32)
    better = n_r >= n
    n_max = torch.maximum(n, n_r)
    return Sim3Result(
        success=n_max >= 20,
        S12=torch.where(better, S_ref, Ss[best]),
        inliers=torch.where(better, inl_r, inls[best]),
        n_inliers=n_max,
    )


# ---------------------------------------------------------------------------
# Sim3 refinement (Optimizer::OptimizeSim3 analog)
# ---------------------------------------------------------------------------


def optimize_sim3(p1_cam, p2_cam, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid, S12_0, K,
                  fix_scale: bool = True, iters: int = 10):
    """LM refinement of a relative Sim3 with both-direction reprojection
    edges: 5 robust iterations, chi2 > 9.21 outlier removal (either direction
    kills the pair), then `iters` plain iterations. Jacobians by forward-mode
    differentiation of the residual in the 7-dof tangent (scale column frozen
    when fix_scale). Returns (S12, inlier_mask, n_inliers)."""
    dev = p1_cam.device
    zero = torch.zeros(7, dtype=torch.float32, device=dev)
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)
    free = torch.ones(7, dtype=torch.float32, device=dev)
    if fix_scale:
        free[6] = 0.0
    pin = torch.diag(1.0 - free)

    def residuals(xi, S0):
        e1, e2 = _reproj(lie.sim3_exp(xi) @ S0, p1_cam, p2_cam, uv1, uv2, K)
        return torch.cat([e1, e2], dim=-1)  # (N,4)

    jac_fn = torch.func.jacfwd(residuals, argnums=0)

    def chi2_pair(r):
        return (torch.sum(r[:, :2] ** 2, -1) * inv_sigma2_1,
                torch.sum(r[:, 2:] ** 2, -1) * inv_sigma2_2)

    def over(c, robust):
        return (c > CHI2_SIM3) if robust else torch.zeros_like(c, dtype=torch.bool)

    def cost_of(S, inlier, robust):
        c1, c2 = chi2_pair(residuals(zero, S))

        def hub(c):
            return torch.where(over(c, robust),
                               2.0 * torch.sqrt(CHI2_SIM3 * torch.clamp(c, min=1e-12)) - CHI2_SIM3, c)

        return torch.sum((hub(c1) + hub(c2)) * inlier)

    def lm_phase(S12, inlier, robust, n_it):
        lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
        for _ in range(n_it):
            r = residuals(zero, S12)
            J = jac_fn(zero, S12) * free  # (N,4,7)
            c1, c2 = chi2_pair(r)
            hw1 = torch.where(over(c1, robust), torch.sqrt(CHI2_SIM3 / torch.clamp(c1, min=1e-12)), 1.0)
            hw2 = torch.where(over(c2, robust), torch.sqrt(CHI2_SIM3 / torch.clamp(c2, min=1e-12)), 1.0)
            w1, w2 = inv_sigma2_1 * hw1, inv_sigma2_2 * hw2
            w = torch.stack([w1, w1, w2, w2], dim=-1) * inlier[:, None]  # (N,4)
            H = torch.einsum("nia,ni,nib->ab", J, w, J)
            g = torch.einsum("nia,ni,ni->a", J, w, r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
            if fix_scale:
                Hd = Hd * (1.0 - pin) + pin
            dx = -torch.linalg.solve_ex(Hd, g)[0] * free
            cand = lie.sim3_exp(dx) @ S12
            accept = cost_of(cand, inlier, robust) < cost_of(S12, inlier, robust)
            S12 = torch.where(accept, cand, S12)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
        return S12

    def gate(S12):
        c1, c2 = chi2_pair(residuals(zero, S12))
        return valid & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)

    S12 = lm_phase(S12_0, valid.to(torch.float32), True, 5)
    # Mid-run outlier removal: either direction over the gate kills the pair.
    S12 = lm_phase(S12, gate(S12).to(torch.float32), False, iters)
    inlier = gate(S12)
    return S12, inlier, torch.sum(inlier, dtype=torch.int32)
