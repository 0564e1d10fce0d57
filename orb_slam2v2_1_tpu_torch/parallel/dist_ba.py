"""Bundle adjustment with its observations sharded over a device mesh.

Port of the JAX package's `parallel/dist_ba.py`. The observation list (camera,
point, pixel) is the large axis and is split over the shards of a
`parallel.mesh.Mesh`; poses and points are replicated. Each shard builds its
part of the normal equations, and every sum over observations ends in one
all-reduce over the mesh (`Mesh.reduce`): the block Hessians and gradients,
each matrix-vector product of the preconditioned conjugate gradient (PCG) on
the Schur-reduced camera system, the landmark back-substitution and each
cost. Every process and shard computes the same replicated decisions from the
same totals, so the LM schedule stays in lockstep.

The Gauss-Newton step is written once, `ops.ba.schur_pcg_step`, which the
single-device solver runs over one shard. The JAX package has two copies of
it with different semantics, and both are kept as arguments of the one body:
- `distributed_ba_step` (`make_sharded_ba_step`): IRLS weights times "in
  front of the camera", the fixed cameras' Jacobians kept (their step is
  zeroed after the solve), no guard on a non-finite step, and every pose
  re-orthonormalized after the step;
- the LM schedule (`_lm_run`, `sharded_bundle_adjust_body`,
  `get_sharded_lm_chunk`): the single-device semantics of `ops.ba` (fixed
  cameras' Jacobians zeroed, a non-finite step zeroed), accept / damping /
  early exit as `ops.ba.ba_step_count_lam`. The early exit reads one flag per
  LM iteration (`sync.host`).

Observation arrays need a leading size that divides evenly over the shards
of this process (`Mesh.split` raises otherwise); callers pad with
`valid=False` slots. The cost is O(observations / shards) per shard and step,
plus 2 x `cg_iters` + 5 all-reduces per LM iteration.

`SOLVES` counts the sharded solves by (thread role, label): "local_ba" and
"global_ba" (the full schedule from `models/local_mapping.py` and
`models/loop_closing.py`), "lm_chunk" (the detached runner's chunks),
"step" and "schedule" (direct calls), so a run can show which of its BA
rounds went through the mesh.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from .. import sync
from ..ops import ba, lie
from ..ops.topk import segments
from .mesh import Mesh

SOLVES: dict = {}
_SOLVES_LOCK = threading.Lock()


def _count(label: str) -> None:
    key = (sync.role(), label)
    with _SOLVES_LOCK:
        SOLVES[key] = SOLVES.get(key, 0) + 1


def reset_counts() -> None:
    with _SOLVES_LOCK:
        SOLVES.clear()


class _Shard(NamedTuple):
    """One shard's observations on its device, with their segments by
    camera and by point (fixed for a problem)."""

    obs: ba.Obs
    cam: torch.Tensor
    pt: torch.Tensor
    cam_seg: tuple
    pt_seg: tuple


def shard_obs(mesh: Mesh, obs: ba.Obs, n_cams: int, n_pts: int) -> list[_Shard]:
    """This process's observations split over its shards."""
    parts = [mesh.split(t) for t in obs]
    out = []
    for fields in zip(*parts):
        o = ba.Obs(*fields)
        cam, pt = o.cam_idx.long(), o.pt_idx.long()
        out.append(_Shard(o, cam, pt, segments(cam, n_cams), segments(pt, n_pts)))
    return out


def _shard_problem(sh: _Shard, poses, points, cam_fixed, K, bf) -> ba.BAProblem:
    dev = sh.cam.device
    return ba.BAProblem(poses.to(dev), points.to(dev), sh.obs, cam_fixed.to(dev), K.to(dev), bf)


def _local_system(sh: _Shard, poses, points, cam_fixed, K, bf, robust: bool, step_semantics: bool):
    """A shard's linearization and its local robustified cost (before the
    all-reduce). `step_semantics`: `distributed_ba_step`'s weights and
    Jacobians (see the module doc)."""
    prob = _shard_problem(sh, poses, points, cam_fixed, K, bf)
    r, Jc, Jp, w, cost, _, behind = ba._build_system(prob, robust, sh.obs.valid.to(torch.float32),
                                                     zero_fixed=not step_semantics)
    if step_semantics:
        w = w * ~behind
    return ba.linearization(sh.cam, sh.pt, sh.cam_seg, sh.pt_seg, r, Jc, Jp, w), cost


def _local_cost(sh: _Shard, poses, points, cam_fixed, K, bf, robust: bool):
    """A shard's robustified cost (before the all-reduce)."""
    prob = _shard_problem(sh, poses, points, cam_fixed, K, bf)
    return ba._cost(prob, robust, sh.obs.valid.to(torch.float32))


def _gn_solve(mesh: Mesh, shards, poses, points, cam_fixed, K, bf, lam, robust: bool, cg_iters: int,
              step_semantics: bool = False):
    """One damped GN step over the mesh. Returns (dx_cam, dx_pt, cost0),
    cost0 the all-reduced robustified cost at the input parameters (None
    under `step_semantics`, which has no use for it)."""
    lins, costs = zip(*(_local_system(sh, poses, points, cam_fixed, K, bf, robust, step_semantics)
                        for sh in shards))
    cost0 = None if step_semantics else mesh.reduce(list(costs))
    dx_cam, dx_pt = ba.schur_pcg_step(list(lins), cam_fixed, lam, cg_iters, mesh.reduce,
                                      guard=not step_semantics)
    return dx_cam, dx_pt, cost0


def distributed_ba_step(mesh: Mesh, poses, points, shards, cam_fixed, K, bf, lam: float = 1e-4,
                        cg_iters: int = 16, robust: bool = True):
    """One damped GN step with `distributed_ba_step`'s semantics. Returns
    (new_poses, new_points), replicated."""
    lam_t = torch.tensor(lam, dtype=torch.float32, device=mesh.home)
    dx_cam, dx_pt, _ = _gn_solve(mesh, shards, poses, points, cam_fixed, K, bf, lam_t, robust, cg_iters,
                                 step_semantics=True)
    return lie.orthonormalize(lie.se3_exp(dx_cam) @ poses), points + dx_pt


def _lm_run(mesh: Mesh, shards, poses, points, cam_fixed, K, bf, lam0, iters: int, robust: bool,
            cg_iters: int):
    """Up to `iters` LM iterations from damping `lam0`, each one sharded GN
    solve, with the accept / damping / early-exit schedule of
    `ops.ba.ba_step_count_lam`. Returns (poses, points, lam, converged)."""
    lam = torch.as_tensor(lam0, dtype=torch.float32).to(mesh.home)
    converged = False
    for _ in range(iters):
        dx_cam, dx_pt, cost0 = _gn_solve(mesh, shards, poses, points, cam_fixed, K, bf, lam, robust, cg_iters)
        new_poses = lie.se3_exp(dx_cam) @ poses
        new_points = points + dx_pt
        cost1 = mesh.reduce([_local_cost(sh, new_poses, new_points, cam_fixed, K, bf, robust) for sh in shards])
        accept = cost1 < cost0
        done = accept & (cost0 - cost1 < 1e-3 * cost0 + 1e-6)
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = ba._lam_update(lam, accept)
        if sync.host(done):
            converged = True
            break
    ortho = lie.orthonormalize(poses)
    poses = torch.where(cam_fixed[:, None, None], poses, ortho)
    return poses, points, lam, converged


def _classify_local(sh: _Shard, poses, points, cam_fixed, K, bf) -> _Shard:
    """chi2 + depth-positivity gate on one shard (no collective)."""
    prob = ba.classify_outliers(_shard_problem(sh, poses, points, cam_fixed, K, bf))
    return sh._replace(obs=prob.obs)


def sharded_bundle_adjust_body(mesh: Mesh, shards, poses, points, cam_fixed, K, bf, iters1: int = 5,
                               iters2: int = 10, cg_iters: int = 24):
    """The full sharded LM schedule, the distributed `ops.ba.bundle_adjust`:
    robust rounds, the chi2 cull, plain rounds. Returns (poses, points,
    valid, cost): poses and points replicated, valid this process's
    observations' inlier mask (on the first device), cost all-reduced."""
    lam0 = 1e-4
    poses, points, _, _ = _lm_run(mesh, shards, poses, points, cam_fixed, K, bf, lam0, iters1, True, cg_iters)
    shards = [_classify_local(sh, poses, points, cam_fixed, K, bf) for sh in shards]
    poses, points, _, _ = _lm_run(mesh, shards, poses, points, cam_fixed, K, bf, lam0, iters2, False, cg_iters)
    cost = mesh.reduce([_local_cost(sh, poses, points, cam_fixed, K, bf, False) for sh in shards])
    valid = torch.cat([sh.obs.valid.to(mesh.home) for sh in shards])
    return poses, points, valid, cost


def _at_home(mesh: Mesh, *tensors):
    return [t.to(mesh.home) for t in tensors]


def make_sharded_bundle_adjust(mesh: Mesh, iters1: int = 5, iters2: int = 10, cg_iters: int = 24,
                               label: str = "schedule"):
    """fn(poses, points, obs, cam_fixed, K, bf) -> (poses, points, valid,
    cost): `sharded_bundle_adjust_body` over `mesh` on this process's
    observations `obs`, counted in `SOLVES` under `label`."""

    def solve(poses, points, obs, cam_fixed, K, bf):
        _count(label)
        poses, points, cam_fixed, K = _at_home(mesh, poses, points, cam_fixed, K)
        shards = shard_obs(mesh, obs, poses.shape[0], points.shape[0])
        return sharded_bundle_adjust_body(mesh, shards, poses, points, cam_fixed, K, bf, iters1, iters2, cg_iters)

    return solve


class ShardedLMChunk:
    """fn(poses, points, obs, cam_fixed, K, bf, lam0) -> (poses, points,
    lam, converged): `iters` LM iterations over `mesh` from a threaded
    damping value, so an abortable caller can split a long solve into chunks
    without restarting the damping schedule. It keeps the split of the last
    observation list it was given, so the chunks of one problem split it
    once."""

    def __init__(self, mesh: Mesh, iters: int, robust: bool, cg_iters: int):
        self.mesh, self.iters, self.robust, self.cg_iters = mesh, iters, robust, cg_iters
        self._last = (None, None)

    def __call__(self, poses, points, obs, cam_fixed, K, bf, lam0):
        _count("lm_chunk")
        poses, points, cam_fixed, K = _at_home(self.mesh, poses, points, cam_fixed, K)
        if self._last[0] is not obs:
            self._last = (obs, shard_obs(self.mesh, obs, poses.shape[0], points.shape[0]))
        return _lm_run(self.mesh, self._last[1], poses, points, cam_fixed, K, bf, lam0, self.iters, self.robust,
                       self.cg_iters)


def get_sharded_lm_chunk(mesh: Mesh, iters: int = 3, robust: bool = True, cg_iters: int = 24):
    """The LM chunk over `mesh` (see `ShardedLMChunk`), cached on the mesh
    by its settings."""
    key = ("lm_chunk", iters, robust, cg_iters)
    fn = mesh.cache.get(key)
    if fn is None:
        fn = mesh.cache[key] = ShardedLMChunk(mesh, iters, robust, cg_iters)
    return fn


def make_sharded_ba_step(mesh: Mesh, lam: float = 1e-4, cg_iters: int = 16, robust: bool = True):
    """fn(poses, points, obs, cam_fixed, K, bf) -> (poses, points): one
    `distributed_ba_step` over `mesh`."""

    def step(poses, points, obs, cam_fixed, K, bf):
        _count("step")
        poses, points, cam_fixed, K = _at_home(mesh, poses, points, cam_fixed, K)
        shards = shard_obs(mesh, obs, poses.shape[0], points.shape[0])
        return distributed_ba_step(mesh, poses, points, shards, cam_fixed, K, bf, lam, cg_iters, robust)

    return step
