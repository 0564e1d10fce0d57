"""Camera projection residuals + analytic Jacobians, batched.

Port of the JAX package's `ops/projection.py`. Pose convention: `Tcw` maps
world points to the camera frame; the optimization variable is the
left-multiplied tangent increment `T <- exp(xi) @ T`, xi = [rho, phi].
"""

from __future__ import annotations

import torch

from . import lie


def cam_point(Tcw: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """World point (..., 3) -> camera frame (..., 3)."""
    return (Tcw[..., :3, :3] @ pw[..., None])[..., 0] + Tcw[..., :3, 3]


def project(Tcw: torch.Tensor, pw: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Project world points (..., 3) through Tcw, K=(fx, fy, cx, cy) -> (..., 2)."""
    pc = cam_point(Tcw, pw)
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = K[..., 0] * pc[..., 0] / z + K[..., 2]
    v = K[..., 1] * pc[..., 1] / z + K[..., 3]
    return torch.stack([u, v], dim=-1)


def project_stereo(Tcw, pw, K, bf) -> torch.Tensor:
    """Stereo projection -> (u_left, v, u_right) with u_r = u - bf/z."""
    pc = cam_point(Tcw, pw)
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = K[..., 0] * pc[..., 0] / z + K[..., 2]
    v = K[..., 1] * pc[..., 1] / z + K[..., 3]
    return torch.stack([u, v, u - bf / z], dim=-1)


def _jac_pc(x, y, iz, fx, fy):
    zero = torch.zeros_like(x)
    iz2 = iz * iz
    return (
        torch.stack([fx * iz, zero, -fx * x * iz2]),
        torch.stack([zero, fy * iz, -fy * y * iz2]),
        iz2,
    )


def mono_residual_jac(Tcw, pw, uv_obs, K):
    """Residual (2,) and Jacobians wrt pose tangent (2,6) and point (2,3),
    with r = proj - obs, for a single observation."""
    pc = cam_point(Tcw, pw)
    x, y = pc[0], pc[1]
    iz = 1.0 / torch.clamp(pc[2], min=1e-6)
    fx, fy = K[0], K[1]
    r = torch.stack([fx * x * iz + K[2], fy * y * iz + K[3]]) - uv_obs
    row0, row1, _ = _jac_pc(x, y, iz, fx, fy)
    J_pc = torch.stack([row0, row1])
    J_xi = torch.cat([lie._eye(3, pc), -lie.hat(pc)], dim=-1)
    return r, J_pc @ J_xi, J_pc @ Tcw[:3, :3]


def stereo_residual_jac(Tcw, pw, uvr_obs, K, bf):
    """Residual (3,) and Jacobians (3,6), (3,3) for the stereo edge."""
    pc = cam_point(Tcw, pw)
    x, y = pc[0], pc[1]
    iz = 1.0 / torch.clamp(pc[2], min=1e-6)
    fx, fy = K[0], K[1]
    u = fx * x * iz + K[2]
    v = fy * y * iz + K[3]
    r = torch.stack([u, v, u - bf * iz]) - uvr_obs
    row0, row1, iz2 = _jac_pc(x, y, iz, fx, fy)
    row2 = torch.stack([fx * iz, torch.zeros_like(x), -fx * x * iz2 + bf * iz2])
    J_pc = torch.stack([row0, row1, row2])
    J_xi = torch.cat([lie._eye(3, pc), -lie.hat(pc)], dim=-1)
    return r, J_pc @ J_xi, J_pc @ Tcw[:3, :3]


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of the Huber kernel: 1 inside, delta/|e| outside."""
    return torch.where(
        chi2 <= delta2, torch.ones_like(chi2), torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12))
    )
