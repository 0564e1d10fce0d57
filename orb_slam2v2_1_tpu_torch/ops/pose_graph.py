"""Sim(3) pose-graph optimization (the essential graph).

Port of the JAX package's `ops/pose_graph.py` (the analog of
`Optimizer::OptimizeEssentialGraph`): LM over all keyframe Sim3s with a
fixed-capacity edge list (spanning tree + strong covisibility + loop edges).
Per-edge 7-dof Jacobians come from forward-mode differentiation of the
closed-form residual (`torch.func.vmap(torch.func.jacfwd(...))`); the normal
equations are assembled by scatter-add and solved densely (7 * K unknowns).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie
from .topk import segment_sum, segments, stable_topk


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor  # (E,) int64
    j: torch.Tensor  # (E,) int64
    S_ji: torch.Tensor  # (E,4,4) measured relative Sim3: maps i-coords -> j-coords
    weight: torch.Tensor  # (E,) f32
    valid: torch.Tensor  # (E,) bool


def relative_sim3(S_i: torch.Tensor, S_j: torch.Tensor) -> torch.Tensor:
    """Measurement S_ji = S_j * S_i^{-1} (world->i, world->j poses)."""
    return S_j @ lie.sim3_inverse(S_i)


def _edge_residual(xi_i, xi_j, S_i0, S_j0, S_ji):
    """Residual of an edge under left-multiplied tangent updates."""
    S_i = lie.sim3_exp(xi_i) @ S_i0
    S_j = lie.sim3_exp(xi_j) @ S_j0
    return lie.sim3_log(S_ji @ S_i @ lie.sim3_inverse(S_j))


_edge_jacobians = torch.func.vmap(
    torch.func.jacfwd(_edge_residual, argnums=(0, 1)), in_dims=(None, None, 0, 0, 0)
)


def optimize_pose_graph(sim3_poses: torch.Tensor, fixed: torch.Tensor, edges: PoseGraphEdges,
                        iters: int = 20) -> torch.Tensor:
    """LM over the pose graph: (K,4,4) world->kf Sim3 poses (SE3 embedded
    with s=1), `fixed` (K,) keyframes held, returns the corrected poses."""
    Kn = sim3_poses.shape[0]
    dev = sim3_poses.device
    zero = torch.zeros(7, dtype=torch.float32, device=dev)
    ei, ej = edges.i.long(), edges.j.long()
    ew = edges.weight * edges.valid
    # The four blocks an edge adds to H, (i,i), (j,j), (i,j), (j,i), as flat
    # block indices, and the two rows it adds to g; index pairs repeat.
    block_seg = segments(torch.cat([ei * Kn + ei, ej * Kn + ej, ei * Kn + ej, ej * Kn + ei]), Kn * Kn)
    row_seg = segments(torch.cat([ei, ej]), Kn)
    free = (~fixed).to(torch.float32)

    def total_cost(poses):
        r = _edge_residual(zero, zero, poses[ei], poses[ej], edges.S_ji)
        return torch.sum(torch.sum(r * r, -1) * ew)

    poses = sim3_poses
    lam = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    for _ in range(iters):
        Si, Sj = poses[ei], poses[ej]
        r = _edge_residual(zero, zero, Si, Sj, edges.S_ji)  # (E,7)
        Ji, Jj = _edge_jacobians(zero, zero, Si, Sj, edges.S_ji)  # (E,7,7) each
        w = ew[:, None, None]

        # H as (K,K,7,7) blocks and the gradient g (K,7), summed in edge
        # order (order-exact on every device, see `ops/topk`).
        H = segment_sum(torch.cat([
            torch.einsum("eab,eac->ebc", Ji, Ji * w), torch.einsum("eab,eac->ebc", Jj, Jj * w),
            torch.einsum("eab,eac->ebc", Ji, Jj * w), torch.einsum("eab,eac->ebc", Jj, Ji * w),
        ]), block_seg).reshape(Kn, Kn, 7, 7)
        g = segment_sum(torch.cat([torch.einsum("eab,ea->eb", Ji * w, r),
                                   torch.einsum("eab,ea->eb", Jj * w, r)]), row_seg)

        # Fix the gauge: zero rows/cols of fixed keyframes, damped diagonal.
        Hd = H * free[:, None, None, None] * free[None, :, None, None]
        Hm = Hd.permute(0, 2, 1, 3).reshape(Kn * 7, Kn * 7)
        Hm = Hm + torch.diag(lam * torch.diagonal(Hm) + 1e-6)
        gv = (g * free[:, None]).reshape(-1)

        dx = -torch.linalg.solve_ex(Hm, gv)[0].reshape(Kn, 7) * free[:, None]
        cand = lie.sim3_exp(dx) @ poses
        accept = total_cost(cand) < total_cost(poses)
        poses = torch.where(accept, cand, poses)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
    return poses


def build_edges_from_map(state, loop_i, loop_j, S_loop_ji, covis_threshold: int = 100,
                         max_edges: int = 2048) -> PoseGraphEdges:
    """Edge list for the essential graph: the spanning tree (kf_parent),
    strong covisibility, every persistent past loop edge and the new measured
    loop edge. Measurements come from the current poses except the new loop
    edge, which carries the Sim3 solver's estimate."""
    from ..models.map_state import covisibility

    Kn = state.kf_pose.shape[0]
    dev = state.kf_pose.device
    C = covisibility(state)
    kf_valid = state.kf_valid

    iota = torch.arange(Kn, device=dev)
    upper = iota[:, None] < iota[None, :]
    # Spanning-tree edges child -> parent, symmetrized into the upper
    # triangle; pairs without an edge go to the sentinel row and column.
    par = torch.clamp(state.kf_parent, min=0).long()
    has_par = kf_valid & (state.kf_parent >= 0)
    tree = torch.zeros((Kn + 1, Kn + 1), dtype=torch.bool, device=dev)
    tree[torch.where(has_par, torch.minimum(iota, par), Kn),
         torch.where(has_par, torch.maximum(iota, par), Kn)] = True
    # Past loop edges (persistent).
    le = state.loop_edges.long()
    le_ok = (le[:, 0] >= 0) & (le[:, 1] >= 0)
    tree[torch.where(le_ok, torch.minimum(le[:, 0], le[:, 1]), Kn),
         torch.where(le_ok, torch.maximum(le[:, 0], le[:, 1]), Kn)] = True
    strong = (C >= covis_threshold) & upper
    mask = (tree[:Kn, :Kn] | strong) & upper & kf_valid[:, None] & kf_valid[None, :]

    flat = mask.reshape(-1)
    # Small maps can have fewer than max_edges slots.
    max_edges = min(max_edges, Kn * Kn + 1)
    _, sel = stable_topk(flat.to(torch.int32), max_edges - 1)  # lowest indices first
    valid = flat[sel]
    ei = sel // Kn
    ej = sel % Kn

    S = state.kf_pose  # SE3 poses embed into Sim3 with s=1
    S_ji = relative_sim3(S[ei], S[ej])

    # Append the loop edge with its measured relative Sim3.
    one = torch.ones(1, dtype=torch.bool, device=dev)
    ei = torch.cat([ei, torch.as_tensor(loop_i, device=dev).reshape(1).long()])
    ej = torch.cat([ej, torch.as_tensor(loop_j, device=dev).reshape(1).long()])
    S_ji = torch.cat([S_ji, S_loop_ji[None]])
    valid = torch.cat([valid, one])
    weight = torch.ones(ei.shape[0], dtype=torch.float32, device=dev)
    return PoseGraphEdges(i=ei, j=ej, S_ji=S_ji, weight=weight, valid=valid)
