"""Trajectory and map arithmetic of the correctness check: plain NumPy.

Horn/Umeyama alignment and the absolute trajectory error (the TUM
benchmark's evaluation, as the SLAM port's `utils/trajectory.ate_rmse`
computes it), the orientation error of a pose sequence, and the gap between
a camera-frame map point and the scene point that the keypoint observing it
sees. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def centers(Tcw: np.ndarray) -> np.ndarray:
    """Camera centres (n, 3) of world-to-camera poses (n, 4, 4)."""
    Tcw = np.asarray(Tcw, np.float64)
    return -np.einsum("nji,nj->ni", Tcw[:, :3, :3], Tcw[:, :3, 3])


def umeyama(P: np.ndarray, Q: np.ndarray, with_scale: bool = False):
    """(s, R, t) minimising sum |s R p + t - q|^2 over rows p of P, q of Q
    (n, 3): Umeyama's closed form."""
    P, Q = np.asarray(P, np.float64).T, np.asarray(Q, np.float64).T
    mu_p, mu_q = P.mean(1, keepdims=True), Q.mean(1, keepdims=True)
    Pc, Qc = P - mu_p, Q - mu_q
    U, d, Vt = np.linalg.svd(Qc @ Pc.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(d) @ S) / max((Pc * Pc).sum(), 1e-12)) if with_scale else 1.0
    return s, R, (mu_q - s * R @ mu_p)[:, 0]


def aligned_errors(est_c: np.ndarray, gt_c: np.ndarray, with_scale: bool = False) -> np.ndarray:
    """Per-frame position errors (n,) in metres of estimated camera centres
    after the rigid alignment onto the true ones (a depth sensor fixes the
    scale), or with `with_scale` the similarity (a monocular map's scale is
    arbitrary)."""
    return residuals(est_c, gt_c, *umeyama(est_c, gt_c, with_scale))


def residuals(est_c: np.ndarray, gt_c: np.ndarray, s: float, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Per-frame distances (n,) of estimated camera centres moved by
    X -> s R X + t (`umeyama`'s alignment) to the true ones."""
    return np.linalg.norm((s * (R @ np.asarray(est_c, np.float64).T)).T + t - gt_c, axis=1)


def rotation_errors_deg(est_Tcw: np.ndarray, gt_Tcw: np.ndarray) -> np.ndarray:
    """Per-frame orientation errors (n,) in degrees, both sequences taken
    relative to their first pose: the angle of R_est_k R_est_0^T against
    R_gt_k R_gt_0^T."""
    Re = np.asarray(est_Tcw, np.float64)[:, :3, :3]
    Rg = np.asarray(gt_Tcw, np.float64)[:, :3, :3]
    rel_e = Re @ Re[0].T
    rel_g = Rg @ Rg[0].T
    D = np.einsum("nij,nkj->nik", rel_e, rel_g)
    cos = np.clip((np.trace(D, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def back_project(xy: np.ndarray, depth: np.ndarray, K) -> np.ndarray:
    """Camera-frame points (n, 3) of pixels xy (n, 2) at depths (n,)."""
    fx, fy, cx, cy = K
    return np.stack([(xy[:, 0] - cx) / fx * depth, (xy[:, 1] - cy) / fy * depth, depth], -1)


def sample_depth(depth: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """The depth map's value at the pixel nearest each xy (n, 2); 0 off the image."""
    h, w = depth.shape
    xi = np.rint(xy[:, 0]).astype(np.int64)
    yi = np.rint(xy[:, 1]).astype(np.int64)
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.zeros(len(xy))
    out[inside] = depth[yi[inside], xi[inside]]
    return out
