"""SE(3) / Sim(3) manifold operations, batched over leading dimensions.

Port of the JAX package's `ops/lie.py`.

Conventions (as in the reference):
* Poses are world->camera transforms `Tcw` stored as (..., 4, 4) matrices.
* SE3 tangent vectors are `[rho(3), phi(3)]` (translation first).
* Sim3 elements are 4x4 matrices whose upper-left block is `s*R`; tangent
  vectors are `[rho(3), phi(3), sigma(1)]`.
* Small-angle branches are Taylor-guarded exactly where the JAX code guards,
  and every function is written without in-place writes, so that
  `torch.func.jacfwd` / `vmap` go through them (the Sim3 solver and the pose
  graph take forward-mode Jacobians of `sim3_exp` / `sim3_log`).

float32 throughout; matmuls run in full float32 (TF32 is off package-wide,
see the package docstring).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(x * x, dim=-1)
    small = sq < 1e-16
    safe = torch.where(small, torch.ones_like(sq), sq)
    return torch.where(small, torch.zeros_like(sq), torch.sqrt(safe))


def _sinc(x: torch.Tensor) -> torch.Tensor:
    small = torch.abs(x) < 1e-4
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(safe) / safe)


def _cosc(x: torch.Tensor) -> torch.Tensor:
    small = torch.abs(x) < 1e-4
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 0.5 - x * x / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    theta = _safe_norm(phi)[..., None, None]
    W = hat(phi)
    W2 = W @ W
    return _eye(3, phi) + _sinc(theta) * W + _cosc(theta) * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle, (..., 3, 3) -> (..., 3); handles theta
    near 0 and near pi."""
    # (..., 1) throughout: torch.func promotes a 0-dim tangent times a Python
    # number to float64.
    trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    theta = torch.atan2(_safe_norm(w)[..., None], cos_t)
    generic = w / torch.clamp(_sinc(theta), min=_EPS)

    B = R + _eye(3, R)
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(B, -1, k[..., None, None].expand(*B.shape[:-1], 1))[..., 0]
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=_EPS)
    sign = torch.where(torch.sum(axis * w, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    near_pi = theta * sign * axis

    use_pi = theta[..., 0] > (math.pi - 1e-3)
    return torch.where(use_pi[..., None], near_pi, generic)


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(phi)[..., None, None]
    W = hat(phi)
    W2 = W @ W
    small = torch.abs(theta) < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    c3 = torch.where(
        small, 1.0 / 6.0 - theta * theta / 120.0, (safe - torch.sin(safe)) / (safe**3)
    )
    return _eye(3, phi) + _cosc(theta) * W + c3 * W2


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(phi)[..., None, None]
    W = hat(phi)
    W2 = W @ W
    small = torch.abs(theta) < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    half = safe * 0.5
    cot = torch.where(
        small,
        1.0 / 12.0 + theta * theta / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS)) / (safe * safe),
    )
    return _eye(3, phi) - 0.5 * W + cot * W2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) tangent [rho, phi] (..., 6) -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return make_se3(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) tangent [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    rho = (_left_jacobian_inv(phi) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def project_so3(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) (quaternion round trip); keeps
    composed float32 poses rigid (see the reference's docstring)."""
    return quat_to_rot(rot_to_quat(R))


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block of an SE3 matrix (..., 4, 4)."""
    return make_se3(project_so3(T[..., :3, :3]), T[..., :3, 3])


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], dim=-1)
    bottom = _eye(4, R)[3:4].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (..., 4, 4)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return make_se3(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def make_sim3(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Assemble Sim3 as 4x4 with upper-left `s*R` (s broadcastable (...,))."""
    return make_se3(R * s[..., None, None], t)


def sim3_parts(S: torch.Tensor):
    """Decompose (..., 4, 4) Sim3 -> (R, t, s)."""
    sR = S[..., :3, :3]
    s = torch.linalg.norm(sR[..., 0, :], dim=-1)
    return sR / s[..., None, None], S[..., :3, 3], s


def sim3_inverse(S: torch.Tensor) -> torch.Tensor:
    R, t, s = sim3_parts(S)
    Rt = R.transpose(-1, -2)
    s_inv = torch.reciprocal(s)
    return make_sim3(Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0], s_inv)


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) tangent [rho(3), phi(3), sigma(1)] -> (..., 4, 4), with the
    closed-form W matrix of Strasdat's thesis (g2o's `sim3.h`)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = _sim3_W(_safe_norm(phi), sigma, hat(phi))
    t = (W @ rho[..., None])[..., 0]
    return make_sim3(so3_exp(phi), t, torch.exp(sigma))


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    R, t, s = sim3_parts(S)
    sigma = torch.log(s)
    phi = so3_log(R)
    W = _sim3_W(_safe_norm(phi), sigma, hat(phi))
    rho = _solve3(W, t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def _solve3(W: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x with W x = t for (..., 3, 3) W by Cramer's rule. The reference calls
    an LU solve; `torch.linalg.solve` gives wrong forward derivatives under
    `vmap(jacfwd(...))` when W and t are batched at different levels, and W
    is within a rotation-sized step of a multiple of the identity here."""
    a, b, c = W[..., :, 0], W[..., :, 1], W[..., :, 2]
    bc = torch.linalg.cross(b, c)
    ca = torch.linalg.cross(c, a)
    ab = torch.linalg.cross(a, b)
    det = torch.sum(a * bc, dim=-1, keepdim=True)
    return torch.stack([torch.sum(t * bc, -1), torch.sum(t * ca, -1), torch.sum(t * ab, -1)], -1) / det


def _sim3_W(theta: torch.Tensor, sigma: torch.Tensor, Phi: torch.Tensor) -> torch.Tensor:
    """The W matrix in Sim3 exp, t = W rho: W = A*Phi + B*Phi^2 + C*I with
    scale/angle-dependent coefficients, Taylor-guarded for small sigma and/or
    theta; the unused branch of every `where` is evaluated at a safe
    argument so that its derivative stays finite."""
    theta, sigma = theta[..., None, None], sigma[..., None, None]
    Phi2 = Phi @ Phi
    s = torch.exp(sigma)
    one = torch.ones_like(sigma)

    small_sig = torch.abs(sigma) < 1e-5
    small_th = theta < 1e-5
    safe_sig = torch.where(small_sig, one, sigma)
    safe_th = torch.where(small_th, one, theta)

    C = torch.where(small_sig, 1.0 + sigma / 2.0, (s - 1.0) / safe_sig)

    sig2 = safe_sig * safe_sig
    th2 = safe_th * safe_th
    denom = sig2 + th2
    sin_th, cos_th = torch.sin(safe_th), torch.cos(safe_th)

    a_sig = s * sin_th
    b_sig = s * cos_th
    A_gen = (a_sig * safe_sig + (1.0 - b_sig) * safe_th) / (safe_th * denom)
    B_gen = (C - ((b_sig - 1.0) * safe_sig + a_sig * safe_th) / denom) / th2

    A_sig0 = _cosc(safe_th)
    B_sig0 = (safe_th - sin_th) / (safe_th**3)

    A_th0 = torch.where(small_sig, 0.5 + sigma / 3.0, ((safe_sig - 1.0) * s + 1.0) / sig2)
    B_th0 = torch.where(
        small_sig, 1.0 / 6.0 + sigma / 8.0,
        (s * (0.5 * sig2 - safe_sig + 1.0) - 1.0) / (sig2 * safe_sig),
    )

    A = torch.where(small_th, A_th0, torch.where(small_sig, A_sig0, A_gen))
    B = torch.where(small_th, B_th0, torch.where(small_sig, B_sig0, B_gen))
    return C * _eye(3, Phi) + A * Phi + B * Phi2


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w)
# ---------------------------------------------------------------------------

def _sgn(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0, -1.0, 1.0).to(x.dtype)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> quaternion (..., 4) as (x, y, z, w), w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) * 0.5
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) * 0.5
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) * 0.5
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) * 0.5

    cand_w = torch.stack([_sgn(m21 - m12) * qx, _sgn(m02 - m20) * qy, _sgn(m10 - m01) * qz, qw], -1)
    cand_x = torch.stack([qx, _sgn(m01 + m10) * qy, _sgn(m02 + m20) * qz, _sgn(m21 - m12) * qw], -1)
    cand_y = torch.stack([_sgn(m01 + m10) * qx, qy, _sgn(m12 + m21) * qz, _sgn(m02 - m20) * qw], -1)
    cand_z = torch.stack([_sgn(m02 + m20) * qx, _sgn(m12 + m21) * qy, qz, _sgn(m10 - m01) * qw], -1)

    pivots = torch.stack([qw, qx, qy, qz], dim=-1)
    k = torch.argmax(pivots, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # (...,4,4)
    q = torch.gather(cands, -2, k[..., None, None].expand(*k.shape, 1, 4))[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0).to(q.dtype)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) -> (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1)
    row1 = torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1)
    row2 = torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)
