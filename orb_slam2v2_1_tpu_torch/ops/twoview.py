"""Two-view monocular initialization: batched H/F RANSAC, model selection
and motion reconstruction.

Port of the JAX package's `ops/twoview.py` (the reference's `Initializer`,
src/Initializer.cc): N_RANSAC eight-point hypotheses of the homography H and
of the fundamental matrix F are solved and scored as one batch each, the best
of each is refit by least squares over its consensus set, RH = SH / (SH + SF)
> 0.40 picks H, and the four motions of E and the eight Faugeras motions of H
are audited by a batched `check_rt`; the winner must dominate and see 2.5
degrees of parallax.

The eight-point sets are the reference's own draw: Gumbel top-8 under the two
halves of a split `jax.random` key (H's sets from the first), reproduced
exactly by `ops/prng.py`. `initialize_two_view` takes the key, or the two
(N_RANSAC, 8) sets themselves. The eight-point solves are float64: a set of
eight matches on or near a plane leaves the F system with a near-double null
space, whose float32 null vector two LAPACK builds give 1.4e-4 apart (the
float64 one is within 1e-4 of the reference's float32 one). Everything else
is float32, as in the reference. Singular vectors and eigenvectors come with
a sign of LAPACK's choosing, which H (scaled by its last entry), F (squared
in every score) and the motion sets do not see.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import prng
from .triangulate import projection_matrix, triangulate

N_RANSAC = 200
SIGMA = 1.0
# cos(2.5 deg) in float32, as the reference's jnp.cos(jnp.deg2rad(2.5)).
PARALLAX_COS = float(np.cos(np.deg2rad(np.float32(2.5)), dtype=np.float32))


class TwoViewResult(NamedTuple):
    success: torch.Tensor  # () bool
    R: torch.Tensor  # (3,3) rotation cam1->cam2
    t: torch.Tensor  # (3,) unit translation
    points: torch.Tensor  # (N,3) triangulated in cam1 frame
    good: torch.Tensor  # (N,) bool triangulation-audit pass
    used_h: torch.Tensor  # () bool which model won


def _mat(rows, like: torch.Tensor) -> torch.Tensor:
    """(3,3) float32 tensor from nested rows of 0-dim tensors and numbers."""
    return torch.stack([torch.stack([torch.as_tensor(v, dtype=torch.float32, device=like.device) for v in r])
                        for r in rows])


def _normalize(x: torch.Tensor, valid: torch.Tensor):
    """Mean / mean-absolute-deviation normalization (src/Initializer.cc:749-772)."""
    w = valid.to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(x * w[:, None], dim=0) / n
    md = torch.sum(torch.abs(x - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(md, min=1e-8)
    xn = (x - mean) * s
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    T = _mat([[s[0], zero, -mean[0] * s[0]], [zero, s[1], -mean[1] * s[1]], [zero, zero, 1.0]], x)
    return xn, T


def sample_sets(valid: torch.Tensor, key: prng.Key, k: int = 8) -> torch.Tensor:
    """(N_RANSAC, k) indices of distinct valid matches per hypothesis: the
    reference's `_sample_sets` of `key`."""
    return prng.gumbel_topk_sets(key, valid, N_RANSAC, k)


def _h_rows(x1n: torch.Tensor, x2n: torch.Tensor):
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    return r1, r2


def _f_rows(x1n: torch.Tensor, x2n: torch.Tensor) -> torch.Tensor:
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], -1)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    return (u * s[..., None, :]) @ vt


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) from the right singular vector of the smallest singular
    value of A (..., R, 9), solved in float64."""
    _, _, vt = torch.linalg.svd(A.double(), full_matrices=True)
    return vt[..., 8, :].reshape(vt.shape[:-2] + (3, 3))


def _dlt_h(x1n: torch.Tensor, x2n: torch.Tensor) -> torch.Tensor:
    """Homography from 8 normalized correspondences (ComputeH21,
    src/Initializer.cc:264-303). (..., 8, 2) x 2 -> (..., 3, 3)."""
    return _null_vector(torch.cat(_h_rows(x1n, x2n), dim=-2)).to(x1n.dtype)


def _dlt_f(x1n: torch.Tensor, x2n: torch.Tensor) -> torch.Tensor:
    """Rank-2 fundamental matrix from 8 normalized correspondences
    (ComputeF21, src/Initializer.cc:305-338)."""
    return _rank2(_null_vector(_f_rows(x1n, x2n))).to(x1n.dtype)


def _scale_h(H: torch.Tensor) -> torch.Tensor:
    h22 = H[..., 2, 2]
    return H / torch.where(torch.abs(h22) < 1e-12, torch.ones_like(h22), h22)[..., None, None]


def _fit_f_ls(x1n, x2n, w, T1, T2):
    """Weighted least-squares F over all inliers (9x9 eigh), rank 2,
    denormalized: the LO-RANSAC refit of the consensus set."""
    Aw = _f_rows(x1n, x2n) * w[:, None]
    _, evecs = torch.linalg.eigh(Aw.T @ Aw)
    return T2.T @ _rank2(evecs[:, 0].reshape(3, 3)) @ T1


def _fit_h_ls(x1n, x2n, w, T1, T2):
    """Weighted least-squares H over all inliers (9x9 eigh), denormalized."""
    r1, r2 = _h_rows(x1n, x2n)
    A = torch.cat([r1 * w[:, None], r2 * w[:, None]], dim=0)
    _, evecs = torch.linalg.eigh(A.T @ A)
    return _scale_h(torch.linalg.inv(T2) @ evecs[:, 0].reshape(3, 3) @ T1)


def _transfer(H: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N) squared transfer error of a through H (..., 3, 3) against b."""
    h = H[..., None, :, :]
    w = h[..., 2, 0] * a[:, 0] + h[..., 2, 1] * a[:, 1] + h[..., 2, 2]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    u = (h[..., 0, 0] * a[:, 0] + h[..., 0, 1] * a[:, 1] + h[..., 0, 2]) / w
    v = (h[..., 1, 0] * a[:, 0] + h[..., 1, 1] * a[:, 1] + h[..., 1, 2]) / w
    return ((b[:, 0] - u) ** 2 + (b[:, 1] - v) ** 2) / (SIGMA * SIGMA)


def _score(c1, c2, valid, th: float, th_score: float):
    in1, in2 = c1 < th, c2 < th
    zero = torch.zeros((), dtype=torch.float32, device=c1.device)
    score = (torch.sum(torch.where(valid & in1, th_score - c1, zero), -1)
             + torch.sum(torch.where(valid & in2, th_score - c2, zero), -1))
    return score, valid & in1 & in2


def _score_h(H21, H12, x1, x2, valid):
    """Symmetric transfer score and inlier mask of H (..., 3, 3)
    (CheckHomography, src/Initializer.cc:341-388)."""
    return _score(_transfer(H12, x2, x1), _transfer(H21, x1, x2), valid, 5.991, 5.991)


def _epi(F: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N) squared distance of b to the epipolar line F a."""
    f = F[..., None, :, :]
    l0 = f[..., 0, 0] * a[:, 0] + f[..., 0, 1] * a[:, 1] + f[..., 0, 2]
    l1 = f[..., 1, 0] * a[:, 0] + f[..., 1, 1] * a[:, 1] + f[..., 1, 2]
    l2 = f[..., 2, 0] * a[:, 0] + f[..., 2, 1] * a[:, 1] + f[..., 2, 2]
    num = l0 * b[:, 0] + l1 * b[:, 1] + l2
    return num * num / torch.clamp(l0 * l0 + l1 * l1, min=1e-12) / (SIGMA * SIGMA)


def _score_f(F21, x1, x2, valid):
    """Epipolar score and inlier mask of F (..., 3, 3) (CheckFundamental,
    src/Initializer.cc:390-468)."""
    return _score(_epi(F21, x1, x2), _epi(F21.transpose(-1, -2), x2, x1), valid, 3.841, 5.991)


def check_rt(R, t, x1, x2, valid, K, th2: float = 4.0 * SIGMA * SIGMA):
    """Audit candidate motions R (..., 3, 3), t (..., 3) by triangulating the
    matches and counting good points (CheckRT, src/Initializer.cc:798-907).

    Returns (n_good (...), points in cam1 (..., N, 3), good (..., N),
    median parallax cosine (...))."""
    dev = x1.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    T2 = eye.expand(R.shape[:-2] + (4, 4)).clone()
    T2[..., :3, :3] = R
    T2[..., :3, 3] = t
    P1 = projection_matrix(eye, K)
    P2 = projection_matrix(T2, K)
    lead = R.shape[:-2]
    X = triangulate(P1, P2[..., None, :, :], x1.expand(lead + x1.shape), x2.expand(lead + x2.shape))

    finite = torch.all(torch.isfinite(X), dim=-1)
    z1 = X[..., 2]
    z2 = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    o2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]  # camera-2 center in cam1
    r2 = X - o2[..., None, :]
    cosp = torch.sum(X * r2, -1) / torch.clamp(torch.linalg.norm(X, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-12)

    def reproj(P, Xh):
        ph = Xh @ P[..., :, :3].transpose(-1, -2) + P[..., None, :, 3]
        z = ph[..., 2]
        z = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
        return ph[..., :2] / z[..., None]

    e1 = torch.sum((reproj(P1, X) - x1) ** 2, -1)
    e2 = torch.sum((reproj(P2, X) - x2) ** 2, -1)
    good = valid & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998) & (e1 < th2) & (e2 < th2)
    n_good = torch.sum(good, dim=-1, dtype=torch.int32)
    # The reference's 50th-smallest parallax angle (src/Initializer.cc:887-898)
    # as the cosine of sorted order statistic min(50, n_good - 1).
    cos_sorted = torch.sort(torch.where(good, cosp, torch.ones_like(cosp)), dim=-1)[0]
    k = torch.clamp(n_good - 1, min=0, max=50).long()
    med_cos = torch.gather(cos_sorted, -1, k[..., None])[..., 0]
    return n_good, X, good, med_cos


_W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)


def _decompose_e(E: torch.Tensor):
    """E -> (R1, R2, t) (DecomposeE, src/Initializer.cc:909-931)."""
    u, _, vt = torch.linalg.svd(E)
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    W = torch.from_numpy(_W).to(E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    return R1 * torch.sign(torch.linalg.det(R1)), R2 * torch.sign(torch.linalg.det(R2)), t


def _intrinsics(K: torch.Tensor):
    zero = torch.zeros((), dtype=torch.float32, device=K.device)
    Km = _mat([[K[0], zero, K[2]], [zero, K[1], K[3]], [zero, zero, 1.0]], K)
    Kinv = _mat([[1.0 / K[0], zero, -K[2] / K[0]], [zero, 1.0 / K[1], -K[3] / K[1]], [zero, zero, 1.0]], K)
    return Km, Kinv


def _h_motions(H: torch.Tensor, K: torch.Tensor):
    """Faugeras SVD decomposition of a homography into 8 motions
    (ReconstructH, src/Initializer.cc:572-732). Returns (8,3,3) R, (8,3) t."""
    Km, Kinv = _intrinsics(K)
    U, w, Vt = torch.linalg.svd(Kinv @ H @ Km)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    # Case d' > 0.
    dp = torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / dp
    st = torch.stack([root / dp, -root / dp, -root / dp, root / dp])
    # Case d' < 0.
    dn = torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / dn
    sp = torch.stack([root / dn, -root / dn, -root / dn, root / dn])

    Rp, tp = [], []
    for i in range(4):
        Rp.append(_mat([[ct, zero, -st[i]], [zero, one, zero], [st[i], zero, ct]], H))
        tp.append(torch.stack([x1s[i], zero, -x3s[i]]) * (d1 - d3))
    for i in range(4):
        Rp.append(_mat([[cp, zero, sp[i]], [zero, -one, zero], [sp[i], zero, -cp]], H))
        tp.append(torch.stack([x1s[i], zero, x3s[i]]) * (d1 + d3))
    R8 = s * U @ torch.stack(Rp) @ Vt
    t8 = (U @ torch.stack(tp)[..., None])[..., 0]
    return R8, t8 / torch.clamp(torch.linalg.norm(t8, dim=-1, keepdim=True), min=1e-12)


def initialize_two_view(x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor, K: torch.Tensor,
                        key: prng.Key | None = None, sets=None) -> TwoViewResult:
    """Initializer::Initialize (src/Initializer.cc:44-122) on x1 (N,2)
    undistorted pixels of the reference frame, x2 (N,2) their matches in the
    current frame, and valid (N,). Give the (sets_h, sets_f) pair of
    (N_RANSAC, 8) hypothesis sets, or the key whose split draws them."""
    if sets is None:
        if key is None:
            raise ValueError("initialize_two_view needs a key or the hypothesis sets")
        sets = tuple(sample_sets(valid, k) for k in prng.split(key))
    sets_h, sets_f = (torch.as_tensor(s, device=x1.device).long() for s in sets)
    x1n, T1 = _normalize(x1, valid)
    x2n, T2 = _normalize(x2, valid)

    # All hypotheses of each model at once.
    Hs = _scale_h(torch.linalg.inv(T2) @ _dlt_h(x1n[sets_h], x2n[sets_h]) @ T1)
    h_scores, _ = _score_h(Hs, torch.linalg.inv(Hs), x1, x2, valid)
    Fs = T2.T @ _dlt_f(x1n[sets_f], x2n[sets_f]) @ T1
    f_scores, _ = _score_f(Fs, x1, x2, valid)
    H21, F21 = Hs[torch.argmax(h_scores)], Fs[torch.argmax(f_scores)]
    _, h_inliers = _score_h(H21, torch.linalg.inv(H21), x1, x2, valid)
    _, f_inliers = _score_f(F21, x1, x2, valid)

    # LO-RANSAC refit on the consensus sets.
    H21 = _fit_h_ls(x1n, x2n, h_inliers.to(torch.float32), T1, T2)
    F21 = _fit_f_ls(x1n, x2n, f_inliers.to(torch.float32), T1, T2)
    SH, h_inliers = _score_h(H21, torch.linalg.inv(H21), x1, x2, valid)
    SF, f_inliers = _score_f(F21, x1, x2, valid)
    use_h = SH / torch.clamp(SH + SF, min=1e-12) > 0.40

    # The 4 motions of E, then the 8 of H, audited on the chosen model's
    # inliers; the other model's slots score 0.
    Km, _ = _intrinsics(K)
    R1, R2, te = _decompose_e(Km.T @ F21 @ Km)
    h_R, h_t = _h_motions(H21, K)
    R_all = torch.cat([torch.stack([R1, R1, R2, R2]), h_R])  # (12,3,3)
    t_all = torch.cat([torch.stack([te, -te, te, -te]), h_t])  # (12,3)
    inl = torch.where(use_h, h_inliers, f_inliers)
    is_h_slot = torch.arange(12, device=x1.device) >= 4
    slot_on = torch.where(use_h, is_h_slot, ~is_h_slot)
    n_good, X_all, good_all, med_cos = check_rt(R_all, t_all, x1, x2, inl, K)
    n_good = torch.where(slot_on, n_good, torch.zeros_like(n_good))

    best = torch.argmax(n_good)
    n_best = n_good[best]
    n_second = torch.sort(n_good)[0][-2]
    n_inliers = torch.sum(inl, dtype=torch.int32)
    # The reference's acceptance (src/Initializer.cc:497-569) in its robust
    # form: enough good points, a dominant winner, and 2.5 deg of parallax
    # (1 deg in the reference; the JAX package measured warped maps there).
    min_good = torch.clamp((0.9 * n_inliers.to(torch.float32)).to(torch.int32), min=50)
    dominant = n_second.to(torch.float32) < 0.75 * n_best.to(torch.float32)
    success = (n_best >= min_good) & dominant & (med_cos[best] < PARALLAX_COS)
    return TwoViewResult(success=success, R=R_all[best], t=t_all[best], points=X_all[best],
                         good=good_all[best], used_h=use_h)
