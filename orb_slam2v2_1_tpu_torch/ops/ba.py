"""Bundle adjustment: motion-only LM, the structured local-BA window, and
the joint BA over an observation list.

Port of the JAX package's `ops/ba.py`: `pose_optimization` (the analog of
Optimizer::PoseOptimization), the camera-major window solver
`bundle_adjust_window` (Optimizer::LocalBundleAdjustment), and the COO
engine `bundle_adjust` / `ba_step_count_lam` that global BA runs on
(landmarks eliminated by the Schur complement; the reduced camera system is
solved densely by Cholesky, or matrix-free by block-Jacobi PCG).

The reference's `while_loop`s stop on an early-exit flag. In
`pose_optimization` and the window solver each LM iteration reads that flag
once from the device (`sync.host`); the observation-list solver masks the
iterations after the flag instead and hands the flag back unread, so a chunk
of iterations costs its caller one read. Either way the iterations that take
effect, and with them every result, are the reference's.

chi2 thresholds and Huber deltas: 5.991 (mono, 2 dof), 7.815 (stereo, 3 dof).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import sync
from . import lie
from .topk import scatter_last, segment_sum, segments

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class Obs(NamedTuple):
    """Fixed-capacity observation list."""

    cam_idx: torch.Tensor  # (O,) int
    pt_idx: torch.Tensor  # (O,) int
    target: torch.Tensor  # (O, 3) float32 (u, v, u_r)
    inv_sigma2: torch.Tensor  # (O,) float32
    is_stereo: torch.Tensor  # (O,) bool
    valid: torch.Tensor  # (O,) bool


def _delta2(is_stereo: torch.Tensor) -> torch.Tensor:
    return torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(torch.float32)


def _huber_weights(is_stereo: torch.Tensor, chi2: torch.Tensor, robust: bool) -> torch.Tensor:
    """Huber IRLS factor only (1 inside the kernel, delta/|e| outside)."""
    if not robust:
        return torch.ones_like(chi2)
    delta2 = _delta2(is_stereo)
    return torch.where(
        chi2 <= delta2, torch.ones_like(chi2), torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12))
    )


def _obs_weights(obs: Obs, chi2: torch.Tensor, robust: bool) -> torch.Tensor:
    """IRLS weight per observation: information x optional Huber."""
    return obs.inv_sigma2 * _huber_weights(obs.is_stereo, chi2, robust) * obs.valid


def _lam_update(lam: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)


def _diag_blocks(Hfull: torch.Tensor, n: int) -> torch.Tensor:
    """(.., 3n, 3n) -> sum of the three (n, n) diagonal blocks."""
    H = Hfull.reshape(*Hfull.shape[:-2], 3, n, 3, n)
    return H[..., 0, :, 0, :] + H[..., 1, :, 1, :] + H[..., 2, :, 2, :]


def _diag_cols(gfull: torch.Tensor, n: int) -> torch.Tensor:
    """(.., 3n, 3) -> sum over i of rows [i*n, (i+1)*n) of column i."""
    g = gfull.reshape(*gfull.shape[:-2], 3, n, 3)
    return g[..., 0, :, 0] + g[..., 1, :, 1] + g[..., 2, :, 2]


def _rot_cols(b0, b1, b2, x, y, zc):
    return (-b1 * zc + b2 * y, b0 * zc - b2 * x, -b0 * y + b1 * x)


def pose_optimization(Tcw0: torch.Tensor, points: torch.Tensor, obs: Obs,
                      K: torch.Tensor, bf, rounds: int = 4, iters: int = 10):
    """4 rounds x <= `iters` LM iterations with chi2 outlier gating between
    rounds; Huber on rounds 0-1 only. Returns (Tcw, inlier_mask, n_inliers)."""
    Tcw0 = lie.orthonormalize(Tcw0)
    fx, fy = K[0], K[1]
    pw = points[obs.pt_idx.long()]
    st = obs.is_stereo.to(torch.float32)
    t0, t1, t2 = obs.target[:, 0], obs.target[:, 1], obs.target[:, 2]
    valid = obs.valid.to(torch.float32)
    eye6 = torch.eye(6, dtype=torch.float32, device=Tcw0.device)

    def eval_planes(Tcw):
        pc = pw @ Tcw[:3, :3].T + Tcw[:3, 3]
        x, y, zc = pc[:, 0], pc[:, 1], pc[:, 2]
        iz = 1.0 / torch.clamp(zc, min=1e-6)
        u = fx * x * iz + K[2]
        v = fy * y * iz + K[3]
        ur = u - bf * iz
        r0 = u - t0
        r1 = v - t1
        r2 = (ur - t2) * st
        chi2 = (r0 * r0 + r1 * r1 + r2 * r2) * obs.inv_sigma2
        return (r0, r1, r2), (x, y, zc, iz), chi2

    def cost_of(chi2, robust, inlier):
        return torch.sum(chi2 * _huber_weights(obs.is_stereo, chi2, robust) * valid * inlier)

    Tcw = Tcw0
    inlier = valid
    for robust in (True, True, False, False)[:rounds]:
        lam = torch.tensor(1e-3, dtype=torch.float32, device=Tcw0.device)
        for _ in range(iters):
            (r0, r1, r2), (x, y, zc, iz), chi2 = eval_planes(Tcw)
            w = _obs_weights(obs, chi2, robust) * inlier
            cost0 = cost_of(chi2, robust, inlier)

            iz2 = iz * iz
            a00 = fx * iz
            a02 = -fx * x * iz2
            a11 = fy * iz
            a12 = -fy * y * iz2
            a22 = a02 + bf * iz2
            zero = torch.zeros_like(a00)
            J0 = (a00, zero, a02) + _rot_cols(a00, zero, a02, x, y, zc)
            J1 = (zero, a11, a12) + _rot_cols(zero, a11, a12, x, y, zc)
            J2 = tuple(p * st for p in (a00, zero, a22) + _rot_cols(a00, zero, a22, x, y, zc))
            Jstack = torch.stack(J0 + J1 + J2)  # (18, O)
            Jw = Jstack * w
            H = _diag_blocks(Jw @ Jstack.T, 6)
            g = _diag_cols(Jw @ torch.stack((r0, r1, r2)).T, 6)

            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-10 * eye6
            dx = -torch.linalg.solve_ex(Hd, g)[0]
            T_new = lie.se3_exp(dx) @ Tcw
            _, _, chi2_new = eval_planes(T_new)
            cost1 = cost_of(chi2_new, robust, inlier)
            accept = cost1 < cost0
            done = accept & (cost0 - cost1 < 1e-3 * cost0 + 1e-6)
            Tcw = torch.where(accept, T_new, Tcw)
            lam = _lam_update(lam, accept)
            if sync.host(done):
                break
        _, (_, _, zc, _), chi2 = eval_planes(Tcw)
        inlier = ((chi2 <= _delta2(obs.is_stereo)) & (zc > 1e-6) & obs.valid).to(torch.float32)
    inlier_mask = inlier.bool()
    return Tcw, inlier_mask, torch.sum(inlier_mask, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Structured-window BA: camera-major (C, N) observation layout
# ---------------------------------------------------------------------------


class BAWindow(NamedTuple):
    """Local-BA problem in camera-major layout; `pt_idx[c, n]` is the point
    slot in [0, P) of keypoint slot n of camera c, or P for none."""

    poses: torch.Tensor  # (C,4,4)
    points: torch.Tensor  # (P,3)
    pt_idx: torch.Tensor  # (C,N) int
    target: torch.Tensor  # (C,N,3)
    inv_sigma2: torch.Tensor  # (C,N)
    is_stereo: torch.Tensor  # (C,N) bool
    valid: torch.Tensor  # (C,N) bool
    cam_fixed: torch.Tensor  # (C,) bool
    K: torch.Tensor  # (4,)
    bf: float


def _window_slot_of(win: BAWindow) -> torch.Tensor:
    """(P, C) keypoint slot observing each point per camera (N if none).
    A camera normally observes a point once; where a row holds a point twice
    the later slot wins, as XLA's in-order scatter on the CPU does."""
    C, N = win.pt_idx.shape
    P = win.points.shape[0]
    dev = win.pt_idx.device
    cam = torch.arange(C, device=dev)[:, None].expand(C, N)
    slot = torch.arange(N, dtype=torch.int32, device=dev)[None, :].expand(C, N)
    flat_pt = torch.where(win.valid, win.pt_idx.long(), torch.full_like(win.pt_idx.long(), P))
    base = torch.full(((P + 1) * C,), N, dtype=torch.int32, device=dev)
    out = scatter_last(base, flat_pt * C + cam, slot)
    return out.reshape(P + 1, C)[:P]


def _res_mask(is_stereo: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(is_stereo, dtype=torch.float32)
    return torch.stack([one, one, is_stereo.to(torch.float32)], dim=-1)


def _window_eval(poses, points, win: BAWindow):
    """Residuals (C, N, 3) and behind-camera flags for every (camera, slot)."""
    P = win.points.shape[0]
    pw = points[torch.clamp(win.pt_idx.long(), max=P - 1)]
    pc = torch.einsum("cij,cnj->cni", poses[:, :3, :3], pw) + poses[:, None, :3, 3]
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = win.K[0] * pc[..., 0] / z + win.K[2]
    v = win.K[1] * pc[..., 1] / z + win.K[3]
    ur = u - win.bf / z
    r = (torch.stack([u, v, ur], dim=-1) - win.target) * _res_mask(win.is_stereo)
    return r, pc[..., 2] <= 1e-6


def _window_chi2(r, win: BAWindow):
    return torch.sum(r * r * _res_mask(win.is_stereo), dim=-1) * win.inv_sigma2


def _window_huber(win: BAWindow, chi2, robust: bool):
    return _huber_weights(win.is_stereo, chi2, robust)


def _window_cost(poses, points, win: BAWindow, robust: bool, inlier):
    r, _ = _window_eval(poses, points, win)
    chi2 = _window_chi2(r, win)
    return torch.sum(chi2 * _window_huber(win, chi2, robust) * win.valid * inlier)


def _spd_solve(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve S x = b for SPD S by Cholesky; a failed factorization gives NaN,
    as the reference's cho_factor does."""
    L, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def _window_planar_step(win: BAWindow, slot_of: torch.Tensor, lam: torch.Tensor, robust: bool):
    """Fused eval + Schur-eliminated GN step in planar layout; returns
    (dx_cam (C,6), dx_pt (P,3), cost0 at the input parameters)."""
    P = win.points.shape[0]
    C, N = win.valid.shape
    dev = win.points.device
    fx, fy = win.K[0], win.K[1]

    R = win.poses[:, :3, :3]
    t = win.poses[:, :3, 3]
    pw = win.points[torch.clamp(win.pt_idx.long(), max=P - 1)]
    pc = torch.einsum("cij,cnj->cni", R, pw) + t[:, None, :]
    x, y = pc[..., 0], pc[..., 1]
    zc = pc[..., 2]
    iz = 1.0 / torch.clamp(zc, min=1e-6)
    iz2 = iz * iz

    u = fx * x * iz + win.K[2]
    v = fy * y * iz + win.K[3]
    ur = u - win.bf * iz
    st = win.is_stereo.to(torch.float32)
    r0 = u - win.target[..., 0]
    r1 = v - win.target[..., 1]
    r2 = (ur - win.target[..., 2]) * st

    chi2 = (r0 * r0 + r1 * r1 + r2 * r2) * win.inv_sigma2
    hw = _window_huber(win, chi2, robust)
    w = win.inv_sigma2 * hw * win.valid
    cost0 = torch.sum(chi2 * hw * win.valid)
    free = (~win.cam_fixed)[:, None].to(torch.float32)

    a00 = fx * iz
    a02 = -fx * x * iz2
    a11 = fy * iz
    a12 = -fy * y * iz2
    a22 = a02 + win.bf * iz2
    zero = torch.zeros_like(a00)

    J0 = (a00, zero, a02) + _rot_cols(a00, zero, a02, x, y, zc)
    J1 = (zero, a11, a12) + _rot_cols(zero, a11, a12, x, y, zc)
    J2 = tuple(p * st for p in (a00, zero, a22) + _rot_cols(a00, zero, a22, x, y, zc))

    def jp_row(b0, b1, b2):
        return tuple(
            b0 * R[:, None, 0, k] + b1 * R[:, None, 1, k] + b2 * R[:, None, 2, k]
            for k in range(3)
        )

    P0 = jp_row(a00, zero, a02)
    P1 = jp_row(zero, a11, a12)
    P2 = tuple(p * st for p in jp_row(a00, zero, a22))

    Jrows = (J0, J1, J2)
    Jstack = torch.stack([Jrows[i][a] for i in range(3) for a in range(6)], dim=1)  # (C,18,N)
    JstackF = Jstack * free[:, None, :]
    Jw = JstackF * w[:, None, :]
    Hcc = _diag_blocks(torch.einsum("cxn,cyn->cxy", Jw, JstackF), 6)
    rstack = torch.stack((r0, r1, r2), dim=1)
    gc = _diag_cols(torch.einsum("cxn,cin->cxi", Jw, rstack), 6)

    JF = [[Jrows[i][a] * free for a in range(6)] for i in range(3)]
    Gplanes = [
        w * (JF[0][a] * P0[b] + JF[1][a] * P1[b] + JF[2][a] * P2[b])
        for a in range(6)
        for b in range(3)
    ]
    for (a, b) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        Gplanes.append(w * (P0[a] * P0[b] + P1[a] * P1[b] + P2[a] * P2[b]))
    for b in range(3):
        Gplanes.append(w * (P0[b] * r0 + P1[b] * r1 + P2[b] * r2))
    G = torch.stack(Gplanes, dim=-1)  # (C,N,27)

    slot_c = torch.clamp(slot_of.long(), max=N - 1)
    obs_ok = (slot_of < N).to(G.dtype)[..., None]
    cam_iota = torch.arange(C, device=dev)[None, :]
    flat_idx = (cam_iota * N + slot_c).reshape(-1)
    Gp = G.reshape(C * N, 27)[flat_idx].reshape(P, C, 27) * obs_ok

    h = [torch.sum(Gp[..., 18 + i], dim=1) for i in range(6)]
    gp = [torch.sum(Gp[..., 24 + i], dim=1) for i in range(3)]
    h00 = h[0] * (1 + lam) + 1e-6
    h11 = h[3] * (1 + lam) + 1e-6
    h22 = h[5] * (1 + lam) + 1e-6
    h01, h02, h12 = h[1], h[2], h[4]
    cA = h11 * h22 - h12 * h12
    cB = h02 * h12 - h01 * h22
    cC = h01 * h12 - h02 * h11
    det = h00 * cA + h01 * cB + h02 * cC
    idet = 1.0 / torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))
    i00, i01, i02 = cA * idet, cB * idet, cC * idet
    i11 = (h00 * h22 - h02 * h02) * idet
    i12 = (h01 * h02 - h00 * h12) * idet
    i22 = (h00 * h11 - h01 * h01) * idet
    iH = ((i00, i01, i02), (i01, i11, i12), (i02, i12, i22))

    Bz = torch.stack([Gp[..., [b + 3 * a for a in range(6)]].reshape(P, C * 6) for b in range(3)])
    Uz = torch.stack([sum(iH[xx][yy][:, None] * Bz[yy] for yy in range(3)) for xx in range(3)])
    S = -torch.einsum("xpc,xpd->cd", Uz, Bz)
    Hcc_d = Hcc + (lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-8)[..., None] * torch.eye(
        6, dtype=torch.float32, device=dev
    )
    S4 = S.reshape(C, 6, C, 6)
    ar = torch.arange(C, device=dev)
    S4[ar, :, ar, :] = S4[ar, :, ar, :] + Hcc_d
    S = S4.reshape(C * 6, C * 6)
    free6 = torch.repeat_interleave(~win.cam_fixed, 6)
    S = S + torch.diag(torch.where(free6, 0.0, 1.0).to(torch.float32))

    hig = [sum(iH[xx][yy] * gp[yy] for yy in range(3)) for xx in range(3)]
    corr = sum(torch.einsum("pc,p->c", Bz[xx], hig[xx]) for xx in range(3))
    rhs = -(gc.reshape(-1) - corr) * free6

    dx_cam = _spd_solve(S, rhs).reshape(C, 6)
    dx_cam = dx_cam * (~win.cam_fixed)[:, None]
    dx_cam = torch.where(torch.all(torch.isfinite(dx_cam)), dx_cam, torch.zeros_like(dx_cam))

    hpc = [torch.einsum("pc,c->p", Bz[xx], dx_cam.reshape(-1)) for xx in range(3)]
    dx_pt = torch.stack(
        [-sum(iH[xx][yy] * (gp[yy] + hpc[yy]) for yy in range(3)) for xx in range(3)], dim=-1
    )
    dx_pt = torch.where(torch.all(torch.isfinite(dx_pt)), dx_pt, torch.zeros_like(dx_pt))
    has_obs = torch.any(slot_of < N, dim=1)
    return dx_cam, dx_pt * has_obs[:, None], cost0


def ba_window_steps(win: BAWindow, iters: int = 5, robust: bool = True):
    """<= `iters` LM iterations on the structured window; returns (win, cost)."""
    slot_of = _window_slot_of(win)
    inlier0 = win.valid.to(torch.float32)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=win.points.device)
    for _ in range(iters):
        dx_cam, dx_pt, cost0 = _window_planar_step(win, slot_of, lam, robust)
        new_poses = lie.se3_exp(dx_cam) @ win.poses
        new_points = win.points + dx_pt
        cost1 = _window_cost(new_poses, new_points, win, robust, inlier0)
        accept = cost1 < cost0
        done = accept & (cost0 - cost1 < 1e-3 * cost0 + 1e-6)
        win = win._replace(
            poses=torch.where(accept, new_poses, win.poses),
            points=torch.where(accept, new_points, win.points),
        )
        lam = _lam_update(lam, accept)
        if sync.host(done):
            break
    ortho = lie.orthonormalize(win.poses)
    win = win._replace(poses=torch.where(win.cam_fixed[:, None, None], win.poses, ortho))
    return win, _window_cost(win.poses, win.points, win, robust, inlier0)


def classify_outliers_window(win: BAWindow) -> BAWindow:
    """chi2 + depth-positivity gate on the structured window."""
    r, behind = _window_eval(win.poses, win.points, win)
    chi2 = _window_chi2(r, win)
    good = (chi2 <= _delta2(win.is_stereo)) & ~behind & win.valid
    return win._replace(valid=good)


def bundle_adjust_window(win: BAWindow, iters1: int = 5, iters2: int = 10):
    """`iters1` robust iterations -> outlier cull -> `iters2` plain ones
    (Optimizer::LocalBundleAdjustment schedule)."""
    win, _ = ba_window_steps(win, iters=iters1, robust=True)
    win = classify_outliers_window(win)
    return ba_window_steps(win, iters=iters2, robust=False)


# ---------------------------------------------------------------------------
# Joint BA over an observation list (global BA)
# ---------------------------------------------------------------------------


class BAProblem(NamedTuple):
    poses: torch.Tensor  # (C,4,4) Tcw
    points: torch.Tensor  # (P,3)
    obs: Obs
    cam_fixed: torch.Tensor  # (C,) bool: cameras held constant
    K: torch.Tensor  # (4,)
    bf: float


def _residual_jac_batch(Tcw, pw, target, K, bf):
    """Residuals (O,3) and Jacobians (O,3,6) in the pose tangent [rho, phi]
    of the left-multiplied update, (O,3,3) in the point, and the
    behind-camera flags, for poses (O,4,4) and points (O,3). The third row is
    the stereo disparity term; callers zero it for mono observations."""
    R = Tcw[:, :3, :3]
    pc = (R @ pw[..., None])[..., 0] + Tcw[:, :3, 3]
    x, y = pc[:, 0], pc[:, 1]
    iz = 1.0 / torch.clamp(pc[:, 2], min=1e-6)
    iz2 = iz * iz
    fx, fy = K[0], K[1]

    u = fx * x * iz + K[2]
    v = fy * y * iz + K[3]
    r = torch.stack([u, v, u - bf * iz], dim=-1) - target

    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    row1 = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    row2 = torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], dim=-1)
    J_pc = torch.stack([row0, row1, row2], dim=-2)  # (O,3,3)
    J_pose = torch.cat([J_pc, -(J_pc @ lie.hat(pc))], dim=-1)  # J_pc @ [I, -hat(pc)]
    return r, J_pose, J_pc @ R, pc[:, 2] <= 1e-6


def _build_system(prob: BAProblem, robust: bool, inlier: torch.Tensor):
    """Residuals, Jacobians, IRLS weights, cost, chi2 and behind flags of
    every observation."""
    obs = prob.obs
    rmask = _res_mask(obs.is_stereo)
    cam = obs.cam_idx.long()
    r, Jc, Jp, behind = _residual_jac_batch(
        prob.poses[cam], prob.points[obs.pt_idx.long()], obs.target, prob.K, prob.bf)
    r = r * rmask
    Jc = Jc * rmask[..., None]
    Jp = Jp * rmask[..., None]
    chi2 = torch.sum(r * r * rmask, dim=-1) * obs.inv_sigma2
    hw = _huber_weights(obs.is_stereo, chi2, robust)
    w = obs.inv_sigma2 * hw * obs.valid * inlier
    # Fixed cameras take no step: zero their Jacobians.
    Jc = Jc * (~prob.cam_fixed)[cam].to(r.dtype)[:, None, None]
    cost = torch.sum(chi2 * hw * obs.valid * inlier)
    return r, Jc, Jp, w, cost, chi2, behind


def _cost(prob: BAProblem, robust: bool, inlier: torch.Tensor) -> torch.Tensor:
    return _build_system(prob, robust, inlier)[4]


def _schur_blocks(prob: BAProblem, r, Jc, Jp, w, lam):
    """The block-diagonal Hessians (damped), the gradient blocks, the
    inverse of the damped point blocks, and the observations' segments by
    camera and by point (sums over them are order-exact, see `ops/topk`)."""
    cam = prob.obs.cam_idx.long()
    pt = prob.obs.pt_idx.long()
    cam_seg = segments(cam, prob.poses.shape[0])
    pt_seg = segments(pt, prob.points.shape[0])
    Wc = Jc * w[:, None, None]  # (O,3,6)
    Wp = Jp * w[:, None, None]  # (O,3,3)
    Hcc = segment_sum(torch.einsum("oia,oib->oab", Jc, Wc), cam_seg)
    Hpp = segment_sum(torch.einsum("oia,oib->oab", Jp, Wp), pt_seg)
    gc = segment_sum(torch.einsum("oia,oi->oa", Wc, r), cam_seg)
    gp = segment_sum(torch.einsum("oia,oi->oa", Wp, r), pt_seg)
    dev = r.device
    Hcc_d = Hcc + (lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-8)[..., None] * torch.eye(6, device=dev)
    Hpp_d = Hpp + (lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-8)[..., None] * torch.eye(3, device=dev)
    Hpp_inv = torch.linalg.inv_ex(Hpp_d)[0]
    return cam, pt, cam_seg, pt_seg, Wc, Hcc_d, gc, gp, Hpp_inv


def _schur_solve(prob: BAProblem, r, Jc, Jp, w, lam, cg_iters: int):
    """One damped GN step via landmark Schur elimination + block-Jacobi PCG.
    The reduced camera matrix S is never formed: S x = (Hcc + lam D) x -
    Hcp Hpp^-1 Hpc x goes through observation-indexed gathers and segment
    sums."""
    cam, pt, cam_seg, pt_seg, Wc, Hcc_d, gc, gp, Hpp_inv = _schur_blocks(prob, r, Jc, Jp, w, lam)
    Wp = Jp * w[:, None, None]

    def hpc_x(x):  # Hpc @ x_cam -> (P,3)
        v = torch.einsum("oia,oa->oi", Wc, x[cam])
        return segment_sum(torch.einsum("oia,oi->oa", Jp, v), pt_seg)

    def hcp_y(y):  # Hcp @ y_point -> (C,6)
        v = torch.einsum("oia,oa->oi", Wp, y[pt])
        return segment_sum(torch.einsum("oia,oi->oa", Jc, v), cam_seg)

    def S_apply(x):
        u = torch.einsum("pab,pb->pa", Hpp_inv, hpc_x(x))
        return torch.einsum("cab,cb->ca", Hcc_d, x) - hcp_y(u)

    rhs = -(gc - hcp_y(torch.einsum("pab,pb->pa", Hpp_inv, gp)))
    M_inv = torch.linalg.inv_ex(Hcc_d)[0]  # block-Jacobi preconditioner

    def precond(x):
        return torch.einsum("cab,cb->ca", M_inv, x)

    x = torch.zeros_like(rhs)
    res = rhs
    z = precond(res)
    p = z
    for _ in range(cg_iters):
        Sp = S_apply(p)
        rz = torch.sum(res * z)
        alpha = rz / torch.clamp(torch.sum(p * Sp), min=1e-20)
        x = x + alpha * p
        res = res - alpha * Sp
        z = precond(res)
        beta = torch.sum(res * z) / torch.clamp(rz, min=1e-20)
        p = z + beta * p

    dx_pt = -torch.einsum("pab,pb->pa", Hpp_inv, gp + hpc_x(x))
    return x * (~prob.cam_fixed)[:, None], dx_pt


def _schur_solve_dense(prob: BAProblem, r, Jc, Jp, w, lam):
    """One damped GN step with an explicit reduced camera system: the
    point-camera coupling blocks B (P,C,6,3) are densified, S = Hcc -
    B Hpp^-1 B^T is one (6C, 3P) x (3P, 6C) product, and the solve is a
    dense Cholesky. A failed factorization gives a zero step."""
    C = prob.poses.shape[0]
    P = prob.points.shape[0]
    cam, pt, _, _, Wc, Hcc_d, gc, gp, Hpp_inv = _schur_blocks(prob, r, Jc, Jp, w, lam)

    Bo = torch.einsum("oia,oib->oab", Wc, Jp)  # (O,6,3)
    B = torch.zeros((P, C, 6, 3), dtype=r.dtype, device=r.device)
    # A (point, camera) pair repeats only where a keyframe holds one point at
    # two keypoints, and a sum of two terms does not depend on their order.
    B.index_put_((pt, cam), Bo, accumulate=True)
    U = torch.einsum("pcax,pxy->pcay", B, Hpp_inv)  # B Hpp^-1

    Bm = B.permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    Um = U.permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    S4 = (-(Um @ Bm.T)).reshape(C, 6, C, 6)
    ar = torch.arange(C, device=r.device)
    S4[ar, :, ar, :] = S4[ar, :, ar, :] + Hcc_d
    S = S4.reshape(C * 6, C * 6)
    free6 = torch.repeat_interleave(~prob.cam_fixed, 6)
    # Fixed cameras have zeroed Jacobians: pin their rows to the identity so
    # that S stays SPD; their right-hand side is zero, so their step is too.
    S = S + torch.diag(torch.where(free6, 0.0, 1.0).to(r.dtype))
    rhs = -(gc - torch.einsum("pcay,py->ca", U, gp))
    rhs = rhs * (~prob.cam_fixed)[:, None]

    dx_cam = _spd_solve(S, rhs.reshape(-1)).reshape(C, 6)
    dx_cam = dx_cam * (~prob.cam_fixed)[:, None]
    dx_cam = torch.where(torch.all(torch.isfinite(dx_cam)), dx_cam, torch.zeros_like(dx_cam))

    hpc_dx = torch.einsum("pcax,ca->px", B, dx_cam)
    dx_pt = -torch.einsum("pab,pb->pa", Hpp_inv, gp + hpc_dx)
    dx_pt = torch.where(torch.all(torch.isfinite(dx_pt)), dx_pt, torch.zeros_like(dx_pt))
    return dx_cam, dx_pt


def ba_step_count_lam(prob: BAProblem, lam0, iters: int = 5, cg_iters: int = 24,
                      robust: bool = True, dense: bool = False):
    """Run up to `iters` LM iterations from damping `lam0`; returns (problem,
    cost, lam, converged). The threaded lam lets a caller split a long solve
    into chunks between which it can stop, without restarting the damping
    schedule. The reference leaves its loop at the first converged
    iteration; here the iterations after it are computed and discarded, so
    `converged` comes back as a 0-dim tensor that the caller reads once."""
    dev = prob.poses.device
    inlier0 = prob.obs.valid.to(torch.float32)
    lam = torch.as_tensor(lam0, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        r, Jc, Jp, w, cost0, _, _ = _build_system(prob, robust, inlier0)
        if dense:
            dx_cam, dx_pt = _schur_solve_dense(prob, r, Jc, Jp, w, lam)
        else:
            dx_cam, dx_pt = _schur_solve(prob, r, Jc, Jp, w, lam, cg_iters)
        cand = prob._replace(poses=lie.se3_exp(dx_cam) @ prob.poses, points=prob.points + dx_pt)
        cost1 = _cost(cand, robust, inlier0)
        accept = cost1 < cost0
        take = accept & ~done
        prob = prob._replace(poses=torch.where(take, cand.poses, prob.poses),
                             points=torch.where(take, cand.points, prob.points))
        lam = torch.where(done, lam, _lam_update(lam, accept))
        done = done | (accept & (cost0 - cost1 < 1e-3 * cost0 + 1e-6))
    # Re-orthonormalize optimized poses; fixed cameras stay bit-identical.
    ortho = lie.orthonormalize(prob.poses)
    prob = prob._replace(poses=torch.where(prob.cam_fixed[:, None, None], prob.poses, ortho))
    return prob, _cost(prob, robust, inlier0), lam, done


def ba_step_count(prob: BAProblem, iters: int = 5, cg_iters: int = 24, robust: bool = True,
                  dense: bool = False):
    """Run up to `iters` LM iterations from the initial damping; returns
    (problem, cost)."""
    prob, cost, _, _ = ba_step_count_lam(prob, 1e-4, iters=iters, cg_iters=cg_iters,
                                         robust=robust, dense=dense)
    return prob, cost


def classify_outliers(prob: BAProblem) -> BAProblem:
    """chi2 gate + depth positivity between the two passes of a BA; returns
    the problem with `obs.valid` updated."""
    _, _, _, _, _, chi2, behind = _build_system(prob, False, prob.obs.valid.to(torch.float32))
    good = (chi2 <= _delta2(prob.obs.is_stereo)) & ~behind & prob.obs.valid
    return prob._replace(obs=prob.obs._replace(valid=good))


def bundle_adjust(prob: BAProblem, cg_iters: int = 24):
    """5 robust iterations -> outlier cull -> 10 plain ones
    (Optimizer::LocalBundleAdjustment schedule). Problems small enough for an
    explicit reduced camera matrix take the dense Schur path; the gate is on
    the reduced system's size and on the coupling tensor's footprint
    (2 x P*C*72 bytes per iteration), as in the reference. Larger problems
    fall back to the matrix-free PCG."""
    C = prob.poses.shape[0]
    P = prob.points.shape[0]
    dense = (C * 6 <= 1024) and (P * C * 72 <= 128 * 1024 * 1024)
    prob, _ = ba_step_count(prob, iters=5, cg_iters=cg_iters, robust=True, dense=dense)
    prob = classify_outliers(prob)
    return ba_step_count(prob, iters=10, cg_iters=cg_iters, robust=False, dense=dense)
