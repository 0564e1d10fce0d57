"""The sharded bundle adjustment of the PyTorch port against the JAX package
(CPU).

The JAX package shards over its 8 virtual CPU devices (tests/conftest.py);
the port over a mesh of 8 "cpu" entries, virtual shards on one device. The
same numpy problems, made from a seed with the reference tests' own
generators (tests/test_ba.py, tests/test_dist_ba.py), go through both.

Tolerances, stated per test: one GN step against the reference on 8 shards
poses 2e-4 and points 2e-3 (the reference's own bound between its 8 shards
and 1); the port's 8 shards against its 1 shard poses 1e-3. That step's
reduced camera system keeps the fixed camera's Jacobians, so it is nearly
singular along the gauge, and 40 CG iterations on 24 unknowns walk on the
float32 rounding there: each float32 answer (the reference on 8 shards, the
port on 8 and on 1) lies 1.6e-4 to 3.2e-4 from the float64 solution, and two
of them differ by up to twice that (the port 8 against 1: 3.9e-4; the
reference's own 8 against 1 gap is 1.4e-4 at 40 iterations, 4.8e-4 at 20 and
1.8e-3 at 10). The full LM schedule cost
within 1% and poses within 5e-3 (`lie.project_so3` turns a 3e-6 input
difference into 3e-4 on a rotation about one axis); the inlier mask after the
chi2 cull equal except where an observation's chi2 lies within 1e-3 relative
of its threshold; LM chunks 2 x 3 against 6 iterations within 10% in cost
(the reference's invariant); the routes on a synthetic map poses 5e-3 and cost
10%, the reference's own bound between its local-BA engines
(tests/test_dist_ba.py): an LM run that stops at its first small improvement
ends where its float order takes it, and the reference's own final cost
moves with the number of shards alone by 5% on the global route
(62.08-65.23 over 1, 2, 4 and 8 devices) and 8% on the local one
(62.63-67.76).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JMesh

from orb_slam2v2_1_tpu.models import local_mapping as jlm
from orb_slam2v2_1_tpu.models import loop_closing as jlc
from orb_slam2v2_1_tpu.models.map_state import MapState as JMapState
from orb_slam2v2_1_tpu.ops import ba as jba
from orb_slam2v2_1_tpu.ops import lie as jlie
from orb_slam2v2_1_tpu.parallel import dist_ba as jdist

from orb_slam2v2_1_tpu_torch.models import local_mapping, loop_closing, map_state
from orb_slam2v2_1_tpu_torch.ops import ba
from orb_slam2v2_1_tpu_torch.parallel import dist_ba
from orb_slam2v2_1_tpu_torch.parallel.mesh import Mesh, resolve

from tests.test_ba import BF, K, make_obs, synth_scene
from tests.test_dist_ba import _noisy_problem, synthetic_map_state

torch.set_num_threads(2)

POSE_ATOL = 5e-3


def jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("obs",))


def cpu_mesh(n):
    return Mesh(["cpu"] * n)


def T(a):
    return torch.from_numpy(np.array(a))


def tobs(obs):
    return ba.Obs(*(T(f) for f in obs))


KT, BFT = T(K), float(BF)


def _step_problem(rng):
    """The problem of tests/test_dist_ba.py's sharded step: 4 cameras, 64
    stereo points, 256 observations (8 x 32), perturbed poses and points,
    camera 0 fixed."""
    poses, pts = synth_scene(rng, n_pts=64, n_cams=4)
    obs = make_obs(poses, pts, 0.3, rng, stereo=True)
    C = poses.shape[0]
    poses_n = jlie.se3_exp(jnp.asarray(rng.normal(0, 0.01, (C, 6)).astype(np.float32))) @ poses
    pts_n = pts + jnp.asarray(rng.normal(0, 0.02, pts.shape).astype(np.float32))
    fixed = jnp.asarray([True] + [False] * (C - 1))
    return poses_n, pts_n, obs, fixed


@pytest.fixture(scope="module")
def step_problem():
    return _step_problem(np.random.default_rng(0))


@pytest.fixture(scope="module")
def step_results(step_problem):
    """One GN step (robust=False, cg_iters=40): the reference on 8 shards,
    the port on 8 and on 1."""
    poses, pts, obs, fixed = step_problem
    ref = jdist.make_sharded_ba_step(jmesh(8), cg_iters=40, robust=False)(poses, pts, obs, fixed, K, BF)
    args = (T(poses), T(pts), tobs(obs), T(fixed), KT, BFT)
    got8 = dist_ba.make_sharded_ba_step(cpu_mesh(8), cg_iters=40, robust=False)(*args)
    got1 = dist_ba.make_sharded_ba_step(Mesh(["cpu"]), cg_iters=40, robust=False)(*args)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got8], [x.numpy() for x in got1]


@pytest.mark.parametrize("against", ["reference_8_shards", "port_1_shard"])
def test_sharded_step_parity(step_problem, step_results, against):
    """The port's step on 8 shards: poses within 2e-4 of the reference's on
    8 shards and within 1e-3 of its own on 1 (see the module doc), points
    within 2e-3 of both; the step lowers the pose error."""
    ref, got8, got1 = step_results
    other = ref if against == "reference_8_shards" else got1
    np.testing.assert_allclose(got8[0], other[0], atol=2e-4 if against == "reference_8_shards" else 1e-3)
    np.testing.assert_allclose(got8[1], other[1], atol=2e-3)
    poses_n = step_problem[0]
    gt, _ = synth_scene(np.random.default_rng(0), n_pts=64, n_cams=4)

    def err(ps):
        return float(jnp.linalg.norm(jlie.se3_log(jlie.se3_inverse(jnp.asarray(ps)) @ gt)))

    assert err(got8[0]) < err(np.asarray(poses_n))


@pytest.fixture(scope="module")
def schedule():
    """The full LM schedule (5 robust, the cull, 10 plain; cg_iters=40) on
    tests/test_dist_ba.py's noisy problem: the reference sharded over 8,
    the port sharded over 8, and the port's single-device `bundle_adjust`."""
    prob, gt = _noisy_problem(np.random.default_rng(0))
    ref = jdist.make_sharded_bundle_adjust(jmesh(8), cg_iters=40)(prob.poses, prob.points, prob.obs, prob.cam_fixed,
                                                                 K, BF)
    tprob = ba.BAProblem(T(prob.poses), T(prob.points), tobs(prob.obs), T(prob.cam_fixed), KT, BFT)
    got = dist_ba.make_sharded_bundle_adjust(cpu_mesh(8), cg_iters=40)(*tprob[:4], KT, BFT)
    single, single_cost = ba.bundle_adjust(tprob, cg_iters=40)
    return prob, gt, ref, got, single, single_cost


@pytest.mark.parametrize("against", ["reference_sharded", "port_single_device"])
def test_full_schedule_cost(schedule, against):
    """Final cost within 1% of the reference's sharded cost and of the
    port's `ba.bundle_adjust`; both recover the poses."""
    prob, gt, ref, got, single, single_cost = schedule
    other = float(ref[3]) if against == "reference_sharded" else float(single_cost)
    assert abs(float(got[3]) - other) / max(other, 1e-9) < 0.01, (float(got[3]), other)

    def err(ps):
        return float(jnp.linalg.norm(jlie.se3_log(jlie.se3_inverse(jnp.asarray(ps)) @ gt)))

    assert err(got[0].numpy()) < 0.02 and err(got[0].numpy()) < err(np.asarray(prob.poses))


def test_full_schedule_poses_and_inliers(schedule):
    """Poses within 5e-3 of the reference's sharded solve; the inlier mask
    after the cull equal except observations whose chi2 at the reference's
    solution lies within 1e-3 relative of its threshold."""
    prob, _, ref, got, _, _ = schedule
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=POSE_ATOL)
    rprob = prob._replace(poses=ref[0], points=ref[1])
    chi2 = np.asarray(jba._build_system(rprob, False, prob.obs.valid.astype(jnp.float32))[5])
    th = np.where(np.asarray(prob.obs.is_stereo), jba.CHI2_STEREO, jba.CHI2_MONO)
    near = np.abs(chi2 - th) <= 1e-3 * th
    differ = got[2].numpy() != np.asarray(ref[2])
    assert not np.any(differ & ~near), np.nonzero(differ & ~near)
    assert got[2].shape == ref[2].shape and 0 < got[2].numpy().sum() <= got[2].numel()


def test_lm_chunks_thread_damping():
    """Two 3-iteration chunks with the damping threaded through against one
    6-iteration chunk (4 shards): cost within 10%, the reference's invariant,
    and well under the start's; the port's first chunk ends on the
    reference's damping value."""
    prob, _ = _noisy_problem(np.random.default_rng(0))
    jm = jmesh(4)
    jc3 = jdist.get_sharded_lm_chunk(jm, iters=3, robust=True, cg_iters=40)
    ja = jc3(prob.poses, prob.points, prob.obs, prob.cam_fixed, K, BF, jnp.float32(1e-4))

    mesh = cpu_mesh(4)
    c3 = dist_ba.get_sharded_lm_chunk(mesh, iters=3, robust=True, cg_iters=40)
    c6 = dist_ba.get_sharded_lm_chunk(mesh, iters=6, robust=True, cg_iters=40)
    assert dist_ba.get_sharded_lm_chunk(mesh, iters=3, robust=True, cg_iters=40) is c3
    obs, fixed = tobs(prob.obs), T(prob.cam_fixed)
    p_a, x_a, lam_a, _ = c3(T(prob.poses), T(prob.points), obs, fixed, KT, BFT, 1e-4)
    assert float(lam_a) == float(ja[2]), (float(lam_a), float(ja[2]))
    p_a, x_a, lam_a, _ = c3(p_a, x_a, obs, fixed, KT, BFT, lam_a)
    p_b, x_b, _, _ = c6(T(prob.poses), T(prob.points), obs, fixed, KT, BFT, 1e-4)

    def cost(p, x):
        return float(ba._cost(ba.BAProblem(p, x, obs, fixed, KT, BFT), True, obs.valid.to(torch.float32)))

    c_a, c_b, c_0 = cost(p_a, x_a), cost(p_b, x_b), cost(T(prob.poses), T(prob.points))
    assert c_a < 0.2 * c_0
    assert abs(c_a - c_b) / max(c_b, 1e-9) < 0.1


def _map_arrays(seed=0):
    state = synthetic_map_state(np.random.default_rng(seed))
    return {name: np.asarray(v) for name, v in zip(JMapState._fields, state)}


def _jstate(arrays):
    return JMapState(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("route", ["global", "local"])
def test_routes_against_reference(route):
    """`run_global_bundle_adjustment` and `local_bundle_adjustment_dist`
    over 8 shards on tests/test_dist_ba.py's synthetic map (8 keyframes, 256
    points) against the reference's routes over its 8 devices: poses within
    5e-3, cost within 10% (see the module doc)."""
    arrays = _map_arrays()
    mesh = cpu_mesh(8)
    tstate = map_state.from_numpy(arrays, device="cpu")
    if route == "global":
        jout, jcost = jlc.run_global_bundle_adjustment(_jstate(arrays), K, BF, mesh=jmesh(8))
        out, cost = loop_closing.run_global_bundle_adjustment(tstate, KT, BFT, mesh=mesh)
    else:
        jout, jcost = jlm.local_bundle_adjustment_dist(_jstate(arrays), 7, K, BF, jmesh(8))
        out, cost = local_mapping.local_bundle_adjustment_dist(tstate, 7, KT, BFT, mesh)
    np.testing.assert_allclose(out.kf_pose.numpy(), np.asarray(jout.kf_pose), atol=POSE_ATOL)
    assert abs(float(cost) - float(jcost)) / max(float(jcost), 1e-9) < 0.1, (float(cost), float(jcost))


def test_routes_accept_a_device_list():
    """A plain list of devices routes like a `Mesh`; a mesh of one shard
    takes the single-device solve, bit for bit."""
    arrays = _map_arrays()
    tstate = map_state.from_numpy(arrays, device="cpu")
    a, ca = loop_closing.run_global_bundle_adjustment(tstate, KT, BFT, mesh=["cpu", "cpu"])
    b, cb = loop_closing.global_bundle_adjustment_dist(tstate, KT, BFT, cpu_mesh(2))
    assert torch.equal(a.kf_pose, b.kf_pose) and float(ca) == float(cb)
    c, cc = loop_closing.run_global_bundle_adjustment(tstate, KT, BFT, mesh=["cpu"])
    d, cd = loop_closing.global_bundle_adjustment(tstate, KT, BFT)
    assert torch.equal(c.kf_pose, d.kf_pose) and float(cc) == float(cd)
    assert resolve(["cpu"]) is None and resolve(None) is None and resolve("auto") is None  # no card here


def test_indivisible_observations_raise():
    """An observation count that does not divide over the shards raises
    ValueError naming both sizes, as `shard_map` refuses."""
    prob, _ = _noisy_problem(np.random.default_rng(0))
    obs = ba.Obs(*(T(f)[:250] for f in prob.obs))
    solve = dist_ba.make_sharded_bundle_adjust(cpu_mesh(8))
    with pytest.raises(ValueError, match="250.*8"):
        solve(T(prob.poses), T(prob.points), obs, T(prob.cam_fixed), KT, BFT)


def test_psum_sums_in_shard_order_and_replicates():
    """`Mesh.psum` of per-shard partials: the sum in shard order, replicated
    to every shard (one tensor per distinct device), tuples elementwise."""
    mesh = cpu_mesh(4)
    rng = np.random.default_rng(3)
    parts = [T(rng.normal(size=(5, 3)).astype(np.float32)) for _ in range(4)]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    out = mesh.psum(parts)
    assert len(out) == 4 and all(o is out[0] for o in out) and torch.equal(out[0], want)
    pair = mesh.psum([(p, 2 * p) for p in parts])
    assert torch.equal(pair[3][0], want) and torch.equal(pair[3][1], ((2 * parts[0] + 2 * parts[1]) + 2 * parts[2])
                                                         + 2 * parts[3])
    assert mesh.size == mesh.n_local == 4 and [t.shape[0] for t in mesh.split(torch.zeros(12))] == [3] * 4


def test_ba_problem_matches_the_reference_generator():
    """`utils.synthetic.ba_problem`, the production-scale problem of
    chip_smoke.py's sharded phase, against `__graft_entry__._make_problem`
    at a small size from the same seed: masks exact, poses 1e-5, targets
    1e-3 px, points 1e-6 m; the sharded solve on 4 shards is finite and ends
    within 10% of `ba.bundle_adjust`'s cost on it (at this size the two LM
    runs stop where their float orders take them, 1.4% apart with the
    thread count of a six-worker run; the card holds the full size to 1%)."""
    import __graft_entry__ as graft
    from orb_slam2v2_1_tpu_torch.utils import synthetic

    ref = graft._make_problem(np.random.default_rng(0), 8, 256, 2048)
    got = synthetic.ba_problem(np.random.default_rng(0), 8, 256, 2048, device="cpu")
    for name in ("cam_idx", "pt_idx", "is_stereo", "valid"):
        np.testing.assert_array_equal(getattr(got.obs, name).numpy(), np.asarray(getattr(ref.obs, name)))
    np.testing.assert_allclose(got.obs.target.numpy(), np.asarray(ref.obs.target), atol=1e-3)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=1e-5)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), atol=1e-6)
    assert torch.equal(got.cam_fixed, T(ref.cam_fixed)) and float(got.bf) == float(ref.bf)
    _, cost_ref = ba.bundle_adjust(got, cg_iters=24)
    out = dist_ba.make_sharded_bundle_adjust(cpu_mesh(4), cg_iters=24)(got.poses, got.points, got.obs, got.cam_fixed,
                                                                       got.K, got.bf)
    assert torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()
    assert abs(float(out[3]) - float(cost_ref)) / float(cost_ref) < 0.1, (float(out[3]), float(cost_ref))
