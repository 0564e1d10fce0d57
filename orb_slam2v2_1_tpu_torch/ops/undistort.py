"""Keypoint undistortion (radial-tangential model), batched.

Port of the JAX package's `ops/undistort.py`: fixed-point iteration inverting
the Brown-Conrady forward model with coefficients (k1, k2, p1, p2, k3).
"""

from __future__ import annotations

import torch


def distort_normalized(xn: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Forward model on normalized coords (..., 2)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(uv: torch.Tensor, K: torch.Tensor, dist: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Invert distortion for pixel coords (..., 2) -> undistorted pixels."""
    f = torch.stack([K[0], K[1]])
    c = torch.stack([K[2], K[3]])
    xd = (uv - c) / f
    xn = xd
    for _ in range(iters):
        xn = xd - (distort_normalized(xn, dist) - xn)
    return xn * f + c
