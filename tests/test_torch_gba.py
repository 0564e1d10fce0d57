"""Global bundle adjustment of the PyTorch port against the JAX package (CPU).

The observation-list BA of `ops/ba.py` (system build, dense and PCG Schur
steps, LM chunks, outlier classification, the 5 + 10 schedule), the whole-map
BA and the functions that build its problems, `merge_gba_into_live`, and the detached
`GlobalBARunner` with the `LoopCloser`'s service calls. The same numpy map,
made from a seed, goes through both packages.

Tolerances, stated per test: the system build 1e-4 (relative to the largest
entry); one dense and one PCG Schur step and one chunk of LM iterations rtol
1e-3 (the Schur step is float32-limited: Hcc - B Hpp^-1 B^T cancels, and two
float32 implementations that sum in different orders differ by about 1e-4 of
the step); the full schedules 2e-3 in pose and 2e-2 in points, as the local
BA; outlier masks exact on data whose outliers are gross; the merge 1e-4.
Every wait on the worker thread has a timeout, so a hang fails the test.
"""

import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.models import loop_closing as jlc
from orb_slam2v2_1_tpu.models.offline import _CellBox as JCellBox
from orb_slam2v2_1_tpu.ops import ba as jba

from orb_slam2v2_1_tpu_torch import sync
from orb_slam2v2_1_tpu_torch.models import loop_closing as lc
from orb_slam2v2_1_tpu_torch.models import map_state
from orb_slam2v2_1_tpu_torch.models.offline import _CellBox
from orb_slam2v2_1_tpu_torch.ops import ba

from tests.test_torch_loop import (BF, K_NP, ROT_ATOL, J, T, _covis_np, assert_states_close, jstate_of, se3_exp_np,
                                   synthetic_map_arrays, tstate_of)

torch.set_num_threads(2)

JOIN_S = 120.0  # a worker that has not ended by then hangs
KJ, BFJ = jnp.asarray(K_NP), jnp.float32(BF)
KT = torch.from_numpy(K_NP)


def jcopy(state):
    return jax.tree.map(jnp.copy, state)


@pytest.fixture(scope="module")
def arrays():
    """8 keyframes over 256 points, 16 x 512 x 128 capacity, with 12 gross
    outlier observations (30-60 px off) for the chi2 gate to remove."""
    rng = np.random.default_rng(21)
    a = synthetic_map_arrays(rng)
    k, n = rng.integers(1, 8, 12), rng.integers(0, 128, 12)
    a["kf_xy"][k, n] += rng.choice([-1.0, 1.0], (12, 2)).astype(np.float32) * rng.uniform(30, 60, (12, 2)).astype(np.float32)
    return a


@pytest.fixture(scope="module")
def problems(arrays):
    """The compact GBA problem (16 camera slots, 8 live) in both packages."""
    jprob, _, _ = jlc.build_global_ba_problem_compact(jstate_of(arrays), KJ, BFJ, 16)
    tprob, _, _ = lc.build_global_ba_problem_compact(tstate_of(arrays), KT, BF, 16)
    return jprob, tprob


def assert_rel(got, ref, tol, name=""):
    """Within `tol` of the reference, relative to its largest entry."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-12), (name, np.abs(got - ref).max(), np.abs(ref).max())


# ---------------------------------------------------------------------------
# ops/ba.py, observation-list form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("robust", [True, False])
def test_build_system_parity(problems, robust):
    """Residuals, both Jacobians, weights, cost and chi2 within 1e-4 of the
    reference's largest entry; the behind-camera flags exact."""
    jprob, tprob = problems
    ref = jba._build_system(jprob, robust, jprob.obs.valid.astype(jnp.float32))
    got = ba._build_system(tprob, robust, tprob.obs.valid.to(torch.float32))
    for name, g, r in zip(("r", "Jc", "Jp", "w", "cost", "chi2"), got, ref):
        assert_rel(g.numpy(), r, 1e-4, name)
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(ref[6]))
    assert float(got[4]) > 0


def _step(jprob, tprob, lam, dense):
    jsys = jba._build_system(jprob, True, jprob.obs.valid.astype(jnp.float32))[:4]
    tsys = ba._build_system(tprob, True, tprob.obs.valid.to(torch.float32))[:4]
    lam_t = torch.tensor(lam, dtype=tprob.poses.dtype)
    if dense:
        return jba._schur_solve_dense(jprob, *jsys, jnp.float32(lam)), ba._schur_solve_dense(tprob, *tsys, lam_t)
    return jba._schur_solve(jprob, *jsys, jnp.float32(lam), 24), ba._schur_solve(tprob, *tsys, lam_t, 24)


def _double(prob):
    obs = prob.obs._replace(target=prob.obs.target.double(), inv_sigma2=prob.obs.inv_sigma2.double())
    return prob._replace(poses=prob.poses.double(), points=prob.points.double(), obs=obs, K=prob.K.double())


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "pcg"])
def test_schur_step_parity(problems, dense):
    """One damped Gauss-Newton step by the dense Cholesky and by the PCG. The
    step is limited by float32 cancellation in Hcc - B Hpp^-1 B^T, so it is
    held as the window BA's step is: the port's step is at most twice as far
    from the same step in float64 as the reference's is, and within 2e-3 of
    the reference's largest entry (measured 1.2e-3 dense). Fixed cameras (the
    anchor and the unused slots) take no step. The two solvers agree with
    each other to 2%."""
    jprob, tprob = problems
    ref, got = _step(jprob, tprob, 1e-4, dense)
    _, exact = _step(jprob, _double(tprob), 1e-4, dense)
    for name, g, r, e in zip(("dx_cam", "dx_pt"), got, ref, exact):
        e = e.numpy()
        err_ref = np.abs(np.asarray(r, np.float64) - e).max()
        err_got = np.abs(g.numpy().astype(np.float64) - e).max()
        assert err_got <= 2 * err_ref + 1e-6 * (np.abs(e).max() + 1), (name, err_got, err_ref)
        assert_rel(g.numpy(), r, 2e-3, name)
    assert not got[0][tprob.cam_fixed].any() and got[0].abs().max() > 1e-4
    other = _step(jprob, tprob, 1e-4, not dense)[1]
    assert_rel(got[0].numpy(), other[0].numpy(), 2e-2, "dense against pcg")


def test_failed_cholesky_gives_zero_step(problems):
    """One observation that is not a number poisons the reduced system: the
    factorization fails, and both packages return a zero step, not NaN."""
    jprob, tprob = problems
    k = int(np.flatnonzero(tprob.obs.valid.numpy())[5])
    target = tprob.obs.target.clone()
    target[k, 0] = float("nan")
    ref, got = _step(jprob._replace(obs=jprob.obs._replace(target=J(target.numpy()))),
                     tprob._replace(obs=tprob.obs._replace(target=target)), 1e-4, True)
    for g, r in zip(got, ref):
        assert not np.asarray(r).any()
        assert not g.any()


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "pcg"])
def test_lm_chunk_parity(problems, dense):
    """One chunk of 3 LM iterations with the damping threaded through:
    translations and points rtol 1e-3 (atol 1e-4), rotations within ROT_ATOL
    (the chunk ends in `project_so3`; measured 3.5e-4), cost 1e-3, the same
    damping and the same convergence flag; a second chunk goes on from the
    first's damping."""
    jprob, tprob = problems
    jp, jcost, jlam, jconv = jba.ba_step_count_lam(jprob, jnp.float32(1e-4), iters=3, cg_iters=24, robust=True, dense=dense)
    tp, tcost, tlam, tconv = ba.ba_step_count_lam(tprob, 1e-4, iters=3, cg_iters=24, robust=True, dense=dense)
    np.testing.assert_allclose(tp.poses[:, :3, 3].numpy(), np.asarray(jp.poses)[:, :3, 3], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tp.poses[:, :3, :3].numpy(), np.asarray(jp.poses)[:, :3, :3], atol=ROT_ATOL)
    np.testing.assert_allclose(tp.points.numpy(), np.asarray(jp.points), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-3)
    np.testing.assert_allclose(float(tlam), float(jlam), rtol=1e-6)
    assert bool(tconv) == bool(jconv)
    assert float(tcost) < 0.5 * float(ba._cost(tprob, True, tprob.obs.valid.to(torch.float32)))
    np.testing.assert_array_equal(tp.poses[tprob.cam_fixed].numpy(), tprob.poses[tprob.cam_fixed].numpy())
    jp2, jcost2, jlam2, _ = jba.ba_step_count_lam(jp, jlam, iters=3, cg_iters=24, robust=True, dense=dense)
    tp2, tcost2, tlam2, _ = ba.ba_step_count_lam(tp, tlam, iters=3, cg_iters=24, robust=True, dense=dense)
    np.testing.assert_allclose(float(tcost2), float(jcost2), rtol=2e-3)
    if dense:
        np.testing.assert_allclose(float(tlam2), float(jlam2), rtol=1e-6)
    else:
        # Near the optimum the PCG's convergence test (a cost drop under 1e-3
        # of the cost) sits on float32 noise: the two packages may stop one
        # accepted iteration apart, which halves the damping once.
        assert 0.5 <= float(tlam2) / float(jlam2) <= 2.0
    assert float(tcost2) <= float(tcost)


def test_iterations_after_convergence_change_nothing(problems):
    """The reference leaves its loop at the first converged iteration; the
    port computes the rest and discards them: 12 iterations equal the
    reference's 12 (which stops early), damping included."""
    jprob, tprob = problems
    jp, jcost, jlam, jconv = jba.ba_step_count_lam(jprob, jnp.float32(1e-4), iters=12, robust=False, dense=True)
    tp, tcost, tlam, tconv = ba.ba_step_count_lam(tprob, 1e-4, iters=12, robust=False, dense=True)
    assert bool(jconv) and bool(tconv)
    np.testing.assert_allclose(float(tlam), float(jlam), rtol=1e-6)
    np.testing.assert_allclose(tp.poses.numpy(), np.asarray(jp.poses), atol=2e-3)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-2)


def test_classify_outliers_and_step_count_parity(problems):
    """5 robust iterations, then the chi2 / depth gate: identical `valid`
    (the outliers are 30-60 px off, far from the gate); all 12 planted
    outliers go."""
    jprob, tprob = problems
    jp, jcost = jba.ba_step_count(jprob, iters=5, robust=True, dense=True)
    tp, tcost = ba.ba_step_count(tprob, iters=5, robust=True, dense=True)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-2)
    jc, tc = jba.classify_outliers(jp), ba.classify_outliers(tp)
    np.testing.assert_array_equal(tc.obs.valid.numpy(), np.asarray(jc.obs.valid))
    removed = int(tprob.obs.valid.sum()) - int(tc.obs.valid.sum())
    assert 10 <= removed <= 40


def test_bundle_adjust_parity(problems):
    """The 5 + 10 schedule on the dense path: poses 2e-3, points 2e-2, cost
    1%; the perturbation is undone (cost falls by more than 10x)."""
    jprob, tprob = problems
    jp, jcost = jba.bundle_adjust(jprob, cg_iters=32)
    tp, tcost = ba.bundle_adjust(tprob, cg_iters=32)
    np.testing.assert_allclose(tp.poses.numpy(), np.asarray(jp.poses), atol=2e-3)
    np.testing.assert_allclose(tp.points.numpy(), np.asarray(jp.points), atol=2e-2)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-2)
    np.testing.assert_array_equal(tp.obs.valid.numpy(), np.asarray(jp.obs.valid))
    assert float(tcost) < 0.1 * float(ba._cost(tprob, False, tprob.obs.valid.to(torch.float32)))


def test_bundle_adjust_falls_back_to_pcg(arrays, monkeypatch):
    """Above 170 cameras the reduced system is not formed: `bundle_adjust`
    takes the PCG, here on a problem padded to 176 camera slots, and ends
    within 2e-3 / 2e-2 of the dense result on the same map."""
    tstate = tstate_of(arrays)
    small, _, _ = lc.build_global_ba_problem_compact(tstate, KT, BF, 16)
    pad = 176 - 16
    big = small._replace(
        poses=torch.cat([small.poses, torch.eye(4).expand(pad, 4, 4)]),
        cam_fixed=torch.cat([small.cam_fixed, torch.ones(pad, dtype=torch.bool)]))
    called = []
    real = ba._schur_solve
    monkeypatch.setattr(ba, "_schur_solve", lambda *a: called.append(1) or real(*a))
    got, cost = ba.bundle_adjust(big, cg_iters=32)
    assert called
    ref, ref_cost = ba.bundle_adjust(small, cg_iters=32)
    np.testing.assert_allclose(got.poses[:16].numpy(), ref.poses.numpy(), atol=2e-3)
    np.testing.assert_allclose(got.points.numpy(), ref.points.numpy(), atol=2e-2)
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=2e-2)


# ---------------------------------------------------------------------------
# whole-map BA and the merge
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def solved(arrays):
    """The whole-map BA of both packages on the same map."""
    jstate, tstate = jstate_of(arrays), tstate_of(arrays)
    jopt, jcost = jlc.global_bundle_adjustment(jcopy(jstate), KJ, BFJ)
    topt, tcost = lc.run_global_bundle_adjustment(tstate, KT, BF)
    return jstate, tstate, jopt, topt, float(jcost), float(tcost)


def test_global_bundle_adjustment_parity(solved, arrays):
    """Whole-map BA over all 16 slots (8 live): poses 2e-3, points 2e-2,
    cost 1%, integer fields exact; the input state is untouched and the
    anchor keeps its pose bit for bit."""
    jstate, tstate, jopt, topt, jcost, tcost = solved
    got = map_state.to_numpy(topt)
    np.testing.assert_allclose(got["kf_pose"], np.asarray(jopt.kf_pose), atol=2e-3)
    np.testing.assert_allclose(got["mp_pos"], np.asarray(jopt.mp_pos), atol=2e-2)
    assert_states_close(topt, jopt, atol=0.0, float_fields=())
    np.testing.assert_allclose(tcost, jcost, rtol=1e-2)
    np.testing.assert_array_equal(tstate.kf_pose.numpy(), arrays["kf_pose"])
    np.testing.assert_array_equal(got["kf_pose"][0], arrays["kf_pose"][0])
    assert np.abs(got["kf_pose"] - arrays["kf_pose"]).max() > 1e-3


def _born_arrays(arrays, rng):
    """The live map after the snapshot: keyframe 8 appended as a child of
    keyframe 7 (same observations, a known relative pose), 10 points born
    with it, and slot 3 reused by another keyframe (new sequence number,
    parent 2)."""
    a = {k: np.array(v) for k, v in arrays.items()}
    T_rel = se3_exp_np(np.array([0.05, 0, 0, 0, 0.01, 0], np.float32))
    for name in ("kf_xy", "kf_level", "kf_angle", "kf_desc", "kf_kp_valid", "kf_ur", "kf_mp"):
        a[name][8] = a[name][7]
    a["kf_pose"][8] = T_rel @ a["kf_pose"][7]
    a["kf_valid"][8], a["kf_frame_id"][8], a["kf_parent"][8], a["kf_seq"][8] = True, 99, 7, 8
    new_pts = np.arange(300, 310)
    a["kf_mp"][8, :10] = new_pts
    a["mp_pos"][new_pts] = rng.uniform(-1, 1, (10, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32)
    a["mp_valid"][new_pts] = True
    a["mp_first_seq"][new_pts] = 8
    T_reuse = se3_exp_np(np.array([0.3, 0, 0, 0, 0, 0], np.float32))
    a["kf_pose"][3] = T_reuse @ a["kf_pose"][2]
    a["kf_seq"][3], a["kf_parent"][3] = 100, 2
    a["n_kf"], a["n_seq"] = np.int32(9), np.int32(101)
    a["covis"] = _covis_np(a)
    return a, T_rel, T_reuse


def test_merge_gba_into_live_parity(solved, arrays):
    """The merge of a solve into a map that moved on: within 1e-4 of the
    reference, integer fields exact. Snapshot-era keyframes take their
    optimized poses; the keyframe born meanwhile and the reused slot ride
    their parents' corrections; the points born meanwhile move with their
    observer. The sweeps down the tree cost one counted host read each."""
    jstate, tstate, jopt, topt, _, _ = solved
    live, T_rel, T_reuse = _born_arrays(arrays, np.random.default_rng(3))
    jprob = jlc.build_global_ba_problem(jstate, KJ, BFJ)
    tprob = lc.build_global_ba_problem(tstate, KT, BF)
    # The same optimized map goes into both merges: the reference's.
    opt_poses, opt_points = np.asarray(jopt.kf_pose), np.asarray(jopt.mp_pos)
    jm = jlc.merge_gba_into_live(jstate_of(live), jstate.kf_seq, jstate.kf_valid, jstate.mp_first_seq,
                                 jstate.mp_valid, J(opt_poses), J(opt_points), jprob.cam_fixed)
    sync.reset()
    tm = lc.merge_gba_into_live(tstate_of(live), tstate.kf_seq, tstate.kf_valid, tstate.mp_first_seq,
                                tstate.mp_valid, T(opt_poses), T(opt_points), tprob.cam_fixed)
    assert sync.COUNT["syncs"] == 2  # one sweep that finds work, one that finds none
    assert_states_close(tm, jm, atol=1e-4)
    got = tm.kf_pose.numpy()
    for k in (1, 2, 4, 5, 6, 7):
        np.testing.assert_allclose(got[k], opt_poses[k], atol=1e-6)
    np.testing.assert_allclose(got[8], T_rel @ got[7], atol=1e-5)
    np.testing.assert_allclose(got[3], T_reuse @ got[2], atol=1e-5)
    assert np.abs(got[3] - opt_poses[3]).max() > 0.1  # not the old keyframe's optimized pose
    # A point born during the solve keeps its place in its observer's camera.
    p_old = live["kf_pose"][8][:3, :3] @ live["mp_pos"][305] + live["kf_pose"][8][:3, 3]
    p_new = got[8][:3, :3] @ tm.mp_pos[305].numpy() + got[8][:3, 3]
    np.testing.assert_allclose(p_new, p_old, atol=1e-4)


# ---------------------------------------------------------------------------
# GlobalBARunner and the LoopCloser's service calls
# ---------------------------------------------------------------------------

def _join(runner):
    runner.join(JOIN_S)
    assert not runner.running, "the GBA worker hangs"


def _finalize(closer, box):
    """`finalize_gba` on a helper thread, so that a hang fails the test."""
    errors = []

    def run():
        try:
            closer.finalize_gba(box)
        except BaseException as exc:
            errors.append(exc)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(JOIN_S)
    assert not th.is_alive(), "finalize_gba hangs"
    assert not errors, errors


def _big_state():
    return tstate_of(synthetic_map_arrays(np.random.default_rng(8), n_kf=16, n_pts=2048, Kcap=32, Mcap=4096, N=256))


def test_runner_completes_and_merges(solved, arrays):
    """A detached solve runs to its end on a copy of the map, its result is
    within 2e-3 / 2e-2 of the reference runner's, and `service_gba` merges
    it into the live map, which then equals the inline whole-map BA to the
    same tolerance."""
    jstate, tstate, _, topt, _, _ = solved
    before = [t.clone() for t in tstate]
    runner = lc.GlobalBARunner(KT, BF, chunk_iters=3)
    runner.start(tstate)
    _join(runner)
    assert not runner.aborted and runner.result is not None and runner.n_runs == 1 and len(runner.solve_ms) == 1
    assert all(torch.equal(a, b) for a, b in zip(before, tstate))  # solved on a copy

    jrunner = jlc.GlobalBARunner(KJ, BFJ, chunk_iters=3)
    jrunner.start(jstate)
    jrunner._thread.join(JOIN_S)
    assert not jrunner.running and jrunner.result is not None
    for i, (got, ref) in enumerate(zip(runner.result, jrunner.result)):
        if i < 4 or i == 6:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3 if i == 4 else 2e-2)

    closer = lc.LoopCloser(None, None, True, KT, BF)
    closer.gba_runner, closer.detached_gba = runner, True
    box = _CellBox(tstate)
    assert closer.service_gba(box) and closer.n_gba_merged == 1 and runner.result is None
    np.testing.assert_allclose(box.state.kf_pose.numpy(), topt.kf_pose.numpy(), atol=2e-3)
    np.testing.assert_allclose(box.state.mp_pos.numpy(), topt.mp_pos.numpy(), atol=2e-2)
    assert np.abs(box.state.kf_pose.numpy() - arrays["kf_pose"]).max() > 1e-3
    assert not closer.service_gba(box)  # nothing left to merge


def test_runner_aborts_between_chunks():
    """The stop flag set right after the start: the worker leaves after its
    first chunk and keeps no result."""
    runner = lc.GlobalBARunner(KT, BF, chunk_iters=1)
    runner.start(_big_state())
    runner.abort()
    _join(runner)
    assert runner.aborted and runner.result is None and runner.n_aborted == 1


def test_second_loop_aborts_the_solve_in_flight():
    """A closure that arrives while a solve runs aborts it and starts a new
    one on the corrected map; only the second result is merged."""
    closer = lc.LoopCloser(None, None, True, KT, BF)
    closer.enable_detached_gba(chunk_iters=1)
    box = _CellBox(_big_state())
    closer._gba_pending = True
    closer.service_gba(box)  # starts run 1
    assert closer.gba_runner.running or closer.gba_runner.result is not None
    closer._gba_pending = True  # a second loop closed
    closer.service_gba(box)  # aborts run 1 if it still runs, starts run 2
    assert closer.gba_runner.n_runs == 2
    _finalize(closer, box)
    assert closer.n_gba_merged == 1 and not closer.gba_runner.running
    assert torch.isfinite(box.state.kf_pose).all() and torch.isfinite(box.state.mp_pos).all()


def test_finalize_starts_a_pending_solve(arrays):
    """`finalize_gba` with a closure still pending and no solve in flight
    starts it, waits and merges; without a runner both calls do nothing."""
    idle = lc.LoopCloser(None, None, True, KT, BF)
    box = _CellBox(tstate_of(arrays))
    assert not idle.service_gba(box)
    idle.finalize_gba(box)
    closer = lc.LoopCloser(None, None, True, KT, BF)
    closer.enable_detached_gba()
    closer._gba_pending = True
    _finalize(closer, box)
    assert closer.n_gba_merged == 1 and closer.gba_runner.n_runs == 1 and not closer._gba_pending
    assert np.abs(box.state.kf_pose.numpy() - arrays["kf_pose"]).max() > 1e-3


def test_worker_error_is_raised_by_join(arrays, monkeypatch):
    """An exception on the worker thread does not vanish: `join` raises it."""
    def boom(*a, **k):
        raise FloatingPointError("solver failed")

    monkeypatch.setattr(ba, "ba_step_count_lam", boom)
    runner = lc.GlobalBARunner(KT, BF)
    runner.start(tstate_of(arrays))
    with pytest.raises(FloatingPointError):
        runner.join(JOIN_S)
    assert runner.result is None and not runner.running


def test_host_read_count_is_not_lost_between_threads():
    """The tracker and the GBA worker count their host reads into one
    counter: 8 threads of 2000 reads each, with the interpreter switching
    threads every 10 us, lose none."""
    import sys

    t = torch.zeros(())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        sync.reset()
        threads = [threading.Thread(target=lambda: [sync.host(t) for _ in range(2000)], daemon=True) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(JOIN_S)
        assert not any(th.is_alive() for th in threads)
        assert sync.COUNT["syncs"] == 16000
    finally:
        sys.setswitchinterval(old)


def test_reference_cell_box_is_the_ports():
    """The chunked run's box has the reference's interface."""
    for box in (JCellBox("s"), _CellBox("s")):
        assert box.read() == ("s", 0)
        assert box.mutate(lambda s: s + "t") == "st" and box.state == "st"
