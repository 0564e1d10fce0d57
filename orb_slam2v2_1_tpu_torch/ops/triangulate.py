"""Batched two-view triangulation (DLT, closed-form normal equations).

Port of the JAX package's `ops/triangulate.py`: the inhomogeneous system
A X = -c (w = 1) solved through closed-form 3x3 normal equations.
"""

from __future__ import annotations

import torch


def projection_matrix(Tcw: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) pose + (4,) intrinsics -> (..., 3, 4) P = K [R|t]."""
    zero = torch.zeros((), dtype=torch.float32, device=K.device)
    one = torch.ones((), dtype=torch.float32, device=K.device)
    Km = torch.stack([
        torch.stack([K[0], zero, K[2]]),
        torch.stack([zero, K[1], K[3]]),
        torch.stack([zero, zero, one]),
    ])
    return Km @ Tcw[..., :3, :4]


def _solve3x3(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 solve via adjugate (H x = b)."""
    a00, a01, a02 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    a10, a11, a12 = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    a20, a21, a22 = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    idet = 1.0 / torch.where(torch.abs(det) > 1e-20, det, torch.full_like(det, 1e-20))
    x = torch.stack(
        [
            c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2],
            c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2],
            c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2],
        ],
        dim=-1,
    )
    return x * idet[..., None]


def triangulate(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation. P1, P2: (..., 3, 4) broadcast against x1, x2
    (..., N, 2) pixels. Returns (..., N, 3) world points."""
    P1 = P1.expand(x1.shape[:-1] + (3, 4))
    P2 = P2.expand(x2.shape[:-1] + (3, 4))
    A = torch.stack(
        [
            x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        dim=-2,
    )
    M = A[..., :3]
    c = A[..., 3]
    nrm = torch.clamp(torch.linalg.norm(M, dim=-1, keepdim=True), min=1e-12)
    M = M / nrm
    c = c / nrm[..., 0]
    H = torch.einsum("...ri,...rj->...ij", M, M)
    b = -torch.einsum("...ri,...r->...i", M, c)
    return _solve3x3(H, b)
