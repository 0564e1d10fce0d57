"""Relocalization of the PyTorch port against the JAX package, on the CPU.

`ops/pnp.py` on numpy problems made from a seed;
`models/relocalization.py` on a map and BoW database that the JAX offline
path built from frames 0-15 of the benchmark's orbit at 320x240 (a keyframe
at least every third frame, the shared vocabulary), carried across with
`map_state.from_numpy` and `database_from_numpy`; and relocalization through
the online entry point, `SlamSystem.track_rgbd`, after a blackout.

The RANSAC draws its hypothesis sets from a JAX key in the reference and from
the same key through `ops/prng.py` in the port; the parity tests run both
with the reference's sets injected and with the port's own draws. Tolerances,
per test: hypothesis scores, inlier masks and sets exact; DLT
and RANSAC poses 1e-4 in translation and 5e-3 in rotation (`project_so3`
amplifies float32 differences, ROADMAP queue 3) against the float64 solution
of the same inputs, which the port computes, and within the reference's own
float32 error of the reference's poses; relocalization: the same verdict and
reference keyframe, inlier counts within 2 (3% above 100), pose within 1 cm
and 0.2 deg: the refinement starts from each package's RANSAC pose, and its
4 rounds of at most 10 LM iterations end a few millimetres apart (measured
up to 5.4 mm), while both land 4-8 cm from the ground truth.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.models import frontend as jfrontend
from orb_slam2v2_1_tpu.models import keyframe_database as jkdb
from orb_slam2v2_1_tpu.models import loop_closing as jlc
from orb_slam2v2_1_tpu.models import offline as joff
from orb_slam2v2_1_tpu.models import relocalization as jreloc
from orb_slam2v2_1_tpu.models import system as jsystem
from orb_slam2v2_1_tpu.models.map_state import MapState as JMapState
from orb_slam2v2_1_tpu.ops import orb as jorb
from orb_slam2v2_1_tpu.ops import pnp as jpnp
from orb_slam2v2_1_tpu.ops import vocab as jvocab
from orb_slam2v2_1_tpu.utils import config as jconfig

from orb_slam2v2_1_tpu_torch.models import keyframe_database as kdb
from orb_slam2v2_1_tpu_torch.models import map_state, relocalization, system, tracking
from orb_slam2v2_1_tpu_torch.ops import lie, pnp, prng, topk, vocab
from orb_slam2v2_1_tpu_torch.utils import config, synthetic

torch.set_num_threads(2)

K_NP = np.array([300.0, 300.0, 160.0, 120.0], np.float32)
KW = dict(fx=275.0, fy=275.0, cx=160.0, cy=120.0, width=320, height=240, n_features=500,
          max_keyframes=16, max_map_points=4096, fps=3.0, bf=44.0, th_depth=100.0)
VOCAB_NPZ = jvocab.__file__.replace("ops/vocab.py", "data/vocab.npz")
# The online entry point's blackout: 700 features (the depth initializer wants
# 500 valid keypoints), a keyframe at least every second frame.
SYSTEM_KW = dict(KW, n_features=700, fps=2.0)
RELOC_GT_M = 0.25  # metres, see test_blackout_then_relocalization
# (orbit frame, frame id) of the queries; the frame id seeds the RANSAC keys.
QUERIES = [(8, 40), (11, 41), (14, 40)]


def T(a):
    return torch.from_numpy(np.array(a))


def reference_sets(key, valid):
    return np.asarray(jpnp._sample_sets(key, jnp.asarray(valid), jpnp.N_HYP, jpnp.SAMPLE))


def _assert_pose_close(got, ref, atol=1e-4, rot_atol=5e-3):
    np.testing.assert_allclose(got[..., :3, 3], ref[..., :3, 3], atol=atol)
    np.testing.assert_allclose(got[..., :3, :3], ref[..., :3, :3], atol=rot_atol)


def _centers(poses):
    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])


def _pair(kw):
    return jconfig.SlamConfig(**kw), config.SlamConfig(**kw)


def _run(slam, frames):
    return [slam.track_rgbd(a, b, i * 0.1) for i, (a, b) in enumerate(frames)]


def assert_poses_close(got, ref, mm=2.0, deg=0.05):
    for g, r in zip(got, ref):
        _assert_pose_within(np.asarray(g, np.float64), np.asarray(r, np.float64), mm, deg)


def _assert_pose_within(got, ref, mm=10.0, deg=0.2):
    c_got = -got[:3, :3].T @ got[:3, 3]
    c_ref = -ref[:3, :3].T @ ref[:3, 3]
    assert np.linalg.norm(c_got - c_ref) <= mm * 1e-3
    cos = (np.trace(got[:3, :3].T @ ref[:3, :3]) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) <= deg


def pnp_problem(rng, n=300, outliers=60, noise=0.5):
    """Points 2-6 m in front of a camera at a random pose, their pixels with
    noise, a share replaced by random pixels; per-point octave weights."""
    ang = rng.normal(0, 0.2, 3)
    th = np.linalg.norm(ang)
    k = ang / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = rng.normal(0, 0.3, 3)
    pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 6, n)], -1)
    pw = (pc - t) @ R  # R^T (pc - t)
    uv = np.stack([K_NP[0] * pc[:, 0] / pc[:, 2] + K_NP[2], K_NP[1] * pc[:, 1] / pc[:, 2] + K_NP[3]], -1)
    uv += rng.normal(0, noise, uv.shape)
    bad = rng.choice(n, outliers, replace=False)
    uv[bad] = rng.uniform([0, 0], [320, 240], (outliers, 2))
    level = rng.integers(0, 4, n)
    inv_s2 = (1.0 / 1.2 ** (2 * level)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.05
    Tcw = np.eye(4)
    Tcw[:3, :3], Tcw[:3, 3] = R, t
    return pw.astype(np.float32), uv.astype(np.float32), inv_s2, valid, Tcw


def dlt_f64(pw, uv, K):
    """The reference's DLT in float64 numpy (SO(3) projection by the port's
    `project_so3` in float64): the exact solution of the float32 inputs."""
    xn, yn = (uv[:, 0] - K[2]) / K[0], (uv[:, 1] - K[3]) / K[1]
    X, Y, Z = (pw[:, i].astype(np.float64) for i in range(3))
    o, z = np.ones_like(X), np.zeros_like(X)
    A = np.concatenate([np.stack([X, Y, Z, o, z, z, z, z, -xn * X, -xn * Y, -xn * Z, -xn], -1),
                        np.stack([z, z, z, z, X, Y, Z, o, -yn * X, -yn * Y, -yn * Z, -yn], -1)])
    P = np.linalg.eigh(A.T @ A)[1][:, 0].reshape(3, 4)
    P = P / np.exp(np.mean(np.log(np.maximum(np.linalg.norm(P[:, :3], axis=1), 1e-12))))
    P = -P if np.mean(pw @ P[2, :3] + P[2, 3]) < 0 else P
    out = np.eye(4)
    out[:3, :3] = lie.project_so3(torch.from_numpy(P[:, :3])).numpy()
    out[:3, 3] = P[:, 3]
    return out


def test_dlt_pose_is_the_float64_solution(rng):
    """A batch of 6-point DLT poses equals the float64 solve of the same
    inputs: translation 1e-4, rotation 5e-3."""
    pw, uv, _, _, _ = pnp_problem(rng, n=120, outliers=0, noise=0.2)
    sets = np.stack([rng.choice(120, 6, replace=False) for _ in range(64)])
    got = pnp._dlt_pose(T(pw)[T(sets)], T(uv)[T(sets)], T(K_NP)).numpy()
    _assert_pose_close(got, np.stack([dlt_f64(pw[s], uv[s], K_NP) for s in sets]))


@pytest.mark.parametrize("noise", [0.0, 0.2])
def test_dlt_pose_parity(rng, noise):
    """Against the reference's float32 solve, set by set: the port is never
    farther from the reference than the reference is from the float64
    solution, plus 1e-4 (translation) / 5e-3 (rotation). The reference's own
    float32 error reaches centimetres on ordinary sets (PERF.md)."""
    pw, uv, _, _, _ = pnp_problem(rng, n=120, outliers=0, noise=noise)
    sets = np.stack([rng.choice(120, 6, replace=False) for _ in range(64)])
    got = pnp._dlt_pose(T(pw)[T(sets)], T(uv)[T(sets)], T(K_NP)).numpy()
    ref = np.stack([np.asarray(jpnp._dlt_pose(jnp.asarray(pw[s]), jnp.asarray(uv[s]), jnp.asarray(K_NP)))
                    for s in sets])
    exact = np.stack([dlt_f64(pw[s], uv[s], K_NP) for s in sets])
    for block, tol in ((np.s_[:, :3, 3], 1e-4), (np.s_[:, :3, :3], 5e-3)):
        d_got = np.abs(got[block] - ref[block]).reshape(64, -1).max(-1)
        d_ref = np.abs(exact[block] - ref[block]).reshape(64, -1).max(-1)
        assert np.all(d_got <= d_ref + tol), (d_got - d_ref).max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_ransac_parity_with_injected_sets(seed):
    """RANSAC with the reference's hypothesis sets on exact correspondences
    with 20% outliers: success, best score and inlier mask exact; the pose
    is the float64 DLT of the winning set (1e-4 / 5e-3) and within the
    reference's float32 error of the reference's pose."""
    rng = np.random.default_rng(seed)
    pw, uv, inv_s2, valid, Tcw = pnp_problem(rng, noise=0.0)
    key = jax.random.key(97 + seed)
    ref = jpnp.pnp_ransac(*(jnp.asarray(a) for a in (pw, uv, inv_s2, valid, K_NP)), key)
    sets = reference_sets(key, valid)
    got = pnp.pnp_ransac(T(pw), T(uv), T(inv_s2), T(valid), T(K_NP), sets=T(sets))
    assert bool(got.success) and bool(ref.success)
    assert int(got.n_inliers) == int(ref.n_inliers) >= 200
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    Ts = pnp._dlt_pose(T(pw)[T(sets)], T(uv)[T(sets)], T(K_NP))
    best = int(torch.argmax(pnp.hypothesis_inliers(Ts, T(pw), T(uv), T(inv_s2), T(valid), T(K_NP)).sum(-1)))
    exact = dlt_f64(pw[sets[best]], uv[sets[best]], K_NP)
    _assert_pose_close(got.Tcw.numpy(), exact)
    ref_T = np.asarray(ref.Tcw)
    assert np.abs(got.Tcw.numpy() - ref_T)[:3, 3].max() <= np.abs(exact - ref_T)[:3, 3].max() + 1e-4
    np.testing.assert_allclose(got.Tcw.numpy()[:3, 3], Tcw[:3, 3], atol=1e-3)


def test_hypothesis_scores_exact(rng):
    """Every hypothesis, not only the best: the inlier masks of the port's
    batched test on the reference's 256 poses equal the reference's own
    test, hence the scores."""
    pw, uv, inv_s2, valid, _ = pnp_problem(rng, noise=0.0)
    sets = reference_sets(jax.random.key(5), valid)
    Kj, pwj, uvj = jnp.asarray(K_NP), jnp.asarray(pw), jnp.asarray(uv)

    def ref_hyp(idx):  # the body of the reference's `pnp_ransac.hyp`
        Tj = jpnp._dlt_pose(pwj[idx], uvj[idx], Kj)
        pc = (Tj[:3, :3] @ pwj.T).T + Tj[:3, 3]
        z = jnp.maximum(pc[:, 2], 1e-6)
        u = Kj[0] * pc[:, 0] / z + Kj[2]
        v = Kj[1] * pc[:, 1] / z + Kj[3]
        e2 = ((u - uvj[:, 0]) ** 2 + (v - uvj[:, 1]) ** 2) * jnp.asarray(inv_s2)
        return Tj, jnp.asarray(valid) & (e2 < 5.991) & (pc[:, 2] > 0)

    ref_T, ref_inl = (np.asarray(a) for a in jax.vmap(ref_hyp)(jnp.asarray(sets)))
    got_inl = pnp.hypothesis_inliers(T(ref_T), T(pw), T(uv), T(inv_s2), T(valid), T(K_NP)).numpy()
    np.testing.assert_array_equal(got_inl, ref_inl)
    np.testing.assert_array_equal(got_inl.sum(-1), ref_inl.sum(-1))
    assert ref_inl.sum(-1).max() >= 150


def test_sets_with_few_valid_follow_the_tie_order(rng):
    """Fewer than 6 valid correspondences: the sets take invalid entries in
    index order (the -inf ties of `top_k`), in both; RANSAC fails alike."""
    pw, uv, inv_s2, _, _ = pnp_problem(rng, n=40, outliers=0)
    valid = np.zeros(40, bool)
    valid[[3, 17, 29, 31]] = True
    key = jax.random.key(11)
    g = np.asarray(jnp.where(jnp.asarray(valid)[None, :], jax.random.gumbel(key, (jpnp.N_HYP, 40)), -jnp.inf))
    np.testing.assert_array_equal(topk.stable_topk(T(g), 6)[1].numpy(), np.asarray(jax.lax.top_k(jnp.asarray(g), 6)[1]))
    sets = reference_sets(key, valid)
    assert set(sets[0][:4]) == {3, 17, 29, 31} and list(sets[0][4:]) == [0, 1]
    ref = jpnp.pnp_ransac(*(jnp.asarray(a) for a in (pw, uv, inv_s2, valid, K_NP)), key)
    got = pnp.pnp_ransac(T(pw), T(uv), T(inv_s2), T(valid), T(K_NP), sets=T(sets))
    assert not bool(got.success) and not bool(ref.success)
    assert int(got.n_inliers) == int(ref.n_inliers) <= 4


def test_generator_sets_valid_and_repeatable(rng):
    """With a key: six distinct valid indices per set, the reference's sets
    of the same key, and a successful RANSAC on the problem."""
    pw, uv, inv_s2, valid, _ = pnp_problem(rng, noise=0.0)
    sets = pnp.sample_sets(T(valid), prng.key(3))
    assert sets.shape == (pnp.N_HYP, pnp.SAMPLE) and T(valid)[sets].all()
    assert (sets.sort(dim=1)[0].diff(dim=1) > 0).all()
    np.testing.assert_array_equal(sets.numpy(), reference_sets(jax.random.key(3), valid))
    res = pnp.pnp_ransac(T(pw), T(uv), T(inv_s2), T(valid), T(K_NP), key=prng.key(3))
    assert bool(res.success) and int(res.n_inliers) >= 150
    with pytest.raises(ValueError, match="key"):
        pnp.pnp_ransac(T(pw), T(uv), T(inv_s2), T(valid), T(K_NP))


# ---------------------------------------------------------------------------
# relocalization on a map the reference built
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def built():
    return reference_map()


def reference_map():
    """The reference's map and database after frames 0-15 (loop closer with
    the shared vocabulary, chunks of 5: keyframes at frames 0, 3, ..., 15),
    query frames built by the reference (earlier frames again, under new
    frame ids) and a black frame, and both packages' copies."""
    cfg = jconfig.SlamConfig(**KW)
    imgs, deps, _ = synthetic.orbit_frames(config.SlamConfig(**KW), 16, device="cpu", total=321)
    imgs, deps = imgs.numpy(), deps.numpy()
    npz = np.load(VOCAB_NPZ)
    jvoc = jvocab.load_vocabulary(npz)
    jcl = jlc.LoopCloser(jvoc, jkdb.empty_database(16, 500, 10000), True, jnp.asarray(cfg.K), jnp.float32(cfg.bf))
    jcl.enable_detached_gba()
    _, ok, jstate = joff.track_sequence_rgbd(imgs, deps, cfg, loop_closer=jcl, chunk=5)
    assert bool(np.all(np.asarray(ok)))
    ocfg = jorb.OrbConfig(n_features=cfg.n_features, n_levels=cfg.n_levels, scale=cfg.scale_factor,
                          fast_threshold=cfg.fast_threshold, fast_min_threshold=cfg.fast_min_threshold)
    K = jnp.asarray(cfg.K, jnp.float32)

    def jframe(img, depth, frame_id):
        return jfrontend.build_frame_only(jnp.asarray(img), jnp.asarray(depth), K, jnp.asarray(cfg.dist, jnp.float32),
                                          jnp.float32(cfg.bf), jnp.int32(frame_id), ocfg, True, cfg.width, cfg.height)

    def tframe(jf):
        return tracking.frame_from_numpy({n: np.asarray(v) for n, v in zip(jf._fields, jf)}, device="cpu")

    queries = {q: jframe(imgs[q[0]], deps[q[0]], q[1]) for q in QUERIES}
    black = jframe(np.zeros_like(imgs[0]), np.zeros_like(deps[0]), 40)
    return dict(
        jstate=jstate, jdb=jcl.db, jvoc=jvoc, K=K, bf=float(cfg.bf),
        tstate=map_state.from_numpy({n: np.asarray(v) for n, v in zip(JMapState._fields, jstate)}, device="cpu"),
        tdb=kdb.database_from_numpy({n: np.asarray(v) for n, v in zip(jcl.db._fields, jcl.db)}, device="cpu"),
        tvoc=vocab.load_vocabulary(npz, device="cpu"), tK=torch.from_numpy(np.array(K)),
        queries={q: (jf, tframe(jf)) for q, jf in queries.items()}, black=(black, tframe(black)),
    )


def _reference_sets_for(frame_id):
    return lambda kf, valid: T(reference_sets(jax.random.key(frame_id * 97 + kf), valid.numpy()))


def _inliers(frame_mp):
    return int((np.asarray(frame_mp) >= 0).sum())


def _close_counts(a, b):
    """Inlier counts within 2, or 3% of counts above 100."""
    return abs(a - b) <= max(2, 0.03 * max(a, b))


def _relocalize_both(b, query, sets):
    jf, tf = b["queries"][query]
    ref = jreloc.relocalize(b["jstate"], b["jdb"], b["jvoc"], jf, b["K"], jnp.float32(b["bf"]), query[1])
    got = relocalization.relocalize(b["tstate"], b["tdb"], b["tvoc"], tf, b["tK"], b["bf"], query[1], sets=sets)
    return ref, got


@pytest.mark.parametrize("query", QUERIES)
def test_relocalize_parity(built, query):
    """The whole candidate loop with the reference's sets: the same verdict
    and keyframe, inliers within 2, pose within 1 cm / 0.2 deg, and within
    10 cm of the orbit's ground truth (the map's world is the first camera;
    the reference's own pose is 4-8 cm off there)."""
    ref, got = _relocalize_both(built, query, _reference_sets_for(query[1]))
    _assert_relocalized_alike(ref, got, query)


@pytest.mark.parametrize("query", QUERIES)
def test_relocalize_parity_own_draws(built, query):
    """The same without injected sets: each candidate's RANSAC draws from
    `prng.key(frame_id * 97 + kf)`, and the result is the injected run's."""
    ref, got = _relocalize_both(built, query, None)
    _assert_relocalized_alike(ref, got, query)
    b = built
    injected = relocalization.relocalize(b["tstate"], b["tdb"], b["tvoc"], b["queries"][query][1], b["tK"], b["bf"],
                                         query[1], sets=_reference_sets_for(query[1]))
    assert got[3] == injected[3] and torch.equal(got[1], injected[1]) and torch.equal(got[2], injected[2])


def _assert_relocalized_alike(ref, got, query):
    assert ref[0] and got[0]
    assert got[3] == ref[3]
    _assert_pose_within(got[1].numpy(), np.asarray(ref[1]))
    assert _close_counts(_inliers(got[2]), _inliers(ref[2])) and _inliers(got[2]) >= 50
    gt = synthetic.orbit_pose(query[0], 321) @ np.linalg.inv(synthetic.orbit_pose(0, 321))
    c_est, c_gt = -got[1].numpy()[:3, :3].T @ got[1].numpy()[:3, 3], -gt[:3, :3].T @ gt[:3, 3]
    assert np.linalg.norm(c_est - c_gt) < 0.1


@pytest.mark.parametrize("query", QUERIES)
def test_match_and_pnp_parity(built, query):
    """Each live keyframe as the candidate, with the reference's sets: where
    both packages' refined poses reach 50 inliers, they agree within 2
    inliers (3% above 100) and 1 cm / 0.2 deg, and that happens for at least
    two keyframes; at most one keyframe per query reaches 50 in one package
    only. A minimal 6-point DLT on pixel-quantized keypoints is off by
    decimetres, so which hypothesis wins, and whether the optimization
    recovers from it, can turn on the reference's float32 rounding
    (`ops/pnp.py`). Measured over the 18 candidates of the three queries:
    both reach 50 on 12, neither on 4, one only on 2 (the reference 95 and
    94 inliers, the port 16 and 8)."""
    b = built
    jf, tf = b["queries"][query]
    fid = query[1]
    n_both = n_one = 0
    for kf in range(int(np.asarray(b["jstate"].kf_valid).sum())):
        ref = jreloc._match_and_pnp(b["jstate"], jf, jnp.int32(kf), b["K"], jnp.float32(b["bf"]),
                                    jax.random.key(fid * 97 + kf))
        got = relocalization._match_and_pnp(b["tstate"], tf, kf, b["tK"], b["bf"],
                                            sets=lambda valid, kf=kf: _reference_sets_for(fid)(kf, valid))
        reached = (int(got[3]) >= 50, int(ref[3]) >= 50)
        n_one += reached[0] != reached[1]
        if not all(reached):
            continue
        n_both += 1
        assert _close_counts(int(got[3]), int(ref[3])), (kf, int(got[3]), int(ref[3]))
        _assert_pose_within(got[1].numpy(), np.asarray(ref[1]))
        assert _close_counts(_inliers(got[2]), _inliers(ref[2]))
    assert n_both >= 2 and n_one <= 1, (n_both, n_one)


def test_relocalize_with_generator_and_black_frame(built):
    """With its own draws (a key per candidate) the port relocalizes at
    least two of the three queries; a black frame has no candidate in either
    package."""
    b = built
    hits = [relocalization.relocalize(b["tstate"], b["tdb"], b["tvoc"], b["queries"][q][1], b["tK"], b["bf"], q[1])[0]
            for q in QUERIES]
    assert sum(hits) >= 2, hits
    jb, tb = b["black"]
    assert jreloc.relocalize(b["jstate"], b["jdb"], b["jvoc"], jb, b["K"], jnp.float32(b["bf"]), 40) == (
        False, None, None, None)
    assert relocalization.relocalize(b["tstate"], b["tdb"], b["tvoc"], tb, b["tK"], b["bf"], 40) == (
        False, None, None, None)


def _gap(a, b):
    """(camera-centre distance in mm, rotation angle in deg) between two
    poses."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = (np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2
    return 1e3 * np.linalg.norm(_centers([a]) - _centers([b])), np.degrees(np.arccos(np.clip(cos, -1, 1)))


def blackout_runs():
    """Both packages' SlamSystem through `test_blackout_then_relocalization`'s
    frames: (jslam, tslam, jout, tout, the reference's relocalize calls,
    ground truth). Each relocalize call: (ok, keyframe, Tcw, frame_mp, its
    inputs but the vocabulary, as numpy)."""
    imgs, deps, gt = synthetic.orbit_frames(config.SlamConfig(**SYSTEM_KW), 28, device="cpu", total=321)
    imgs, deps = imgs.numpy(), deps.numpy()
    jcfg, tcfg = _pair(SYSTEM_KW)
    black = (np.zeros_like(imgs[0]), np.zeros_like(deps[0]))
    frames = list(zip(imgs[:28], deps[:28])) + [black, black, (imgs[2], deps[2]), (imgs[3], deps[3])]
    jslam = jsystem.SlamSystem(config=jcfg, sensor=jsystem.Sensor.RGBD)
    tslam = system.SlamSystem(config=tcfg, sensor=system.Sensor.RGBD, device="cpu")
    j_reloc = []
    real = jreloc.relocalize

    def numpy_copy(x):  # the reference donates the map's buffers to later steps
        return {n: np.array(v) for n, v in zip(x._fields, x)} if hasattr(x, "_fields") else np.array(x)

    def counted(*a, **k):
        out = real(*a, **k)
        j_reloc.append((out[0], out[3], *(None if o is None else np.array(o) for o in out[1:3]),
                        [numpy_copy(x) for x in a[:2] + a[3:]]))  # all but the vocabulary
        return out

    jreloc.relocalize = counted
    try:
        jout = _run(jslam, frames)
    finally:
        jreloc.relocalize = real
    tout = _run(tslam, frames)
    return jslam, tslam, jout, tout, j_reloc, gt


def test_blackout_then_relocalization():
    """Frames 0-27 at fps=2, two black frames (lost, no reset: more than 5
    keyframes), then frame 2 again: both packages relocalize on it (the
    reference keyframe shares too little of that view), against the same
    keyframe, to within RELOC_GT_M of the ground truth, and track the next
    frame. At this size, with a keyframe every second frame on a turn in
    place, both maps drift 0.30 m from the ground truth by frame 27
    (relocalized poses: 0.15-0.17 m off), and the two trajectories drift
    apart as the reference drifts from itself under noise (PERF.md).
    Measured gap between the packages: under 0.2 mm up to frame 14, 4-9 mm
    over frames 15-20, 14-56 mm over 21-27 (20.4 mm / 0.24 deg at 27), and
    24.2 mm / 0.28 deg on the relocalized frame. So poses are compared over
    frames 0-9 (2 mm / 0.05 deg); the relocalized pose may add to the gap
    at frame 27 no more than relocalization's own tolerance, 1 cm /
    0.2 deg; and the port's relocalization, run on the reference's map,
    database and frame at that call with the reference's sets, gives the
    reference's keyframe, inliers within 2 (3% above 100) and its pose
    within 1 cm / 0.2 deg."""
    jslam, tslam, jout, tout, j_reloc, gt = blackout_runs()
    for slam, out in ((jslam, jout), (tslam, tout)):
        assert all(o is not None for o in out[:28])
        assert out[28] is None and out[29] is None and out[30] is not None and out[31] is not None
        assert slam.n_kf_host > 5 and slam.n_resets == 0 and slam.state.name == "OK"
    assert [r[0] for r in j_reloc] == [False, False, True] and tslam.n_relocalized == 1
    assert tslam.n_kf_host == jslam.n_kf_host
    assert tslam.trajectory.entries[30].ref_kf == jslam.trajectory.entries[30].ref_kf
    assert_poses_close(tout[:10], jout[:10])
    before, after = _gap(tout[27], jout[27]), _gap(tout[30], jout[30])
    assert after[0] <= before[0] + 10.0 and after[1] <= before[1] + 0.2, (before, after)
    truth = _centers([gt[2] @ np.linalg.inv(gt[0])])
    for out in (tout, jout):
        assert np.linalg.norm(_centers([out[30]]) - truth) < RELOC_GT_M
    lost = [e.lost for e in tslam.trajectory.entries]
    assert lost == [e.lost for e in jslam.trajectory.entries] and lost[28:30] == [True, True]

    # The port's relocalization on the reference's inputs of that call.
    _, ref_kf, ref_T, ref_mp, (jstate, jdb, jframe, K, bf, frame_id) = j_reloc[2]
    got = relocalization.relocalize(
        map_state.from_numpy(jstate, device="cpu"), kdb.database_from_numpy(jdb, device="cpu"),
        vocab.load_vocabulary(np.load(VOCAB_NPZ), device="cpu"), tracking.frame_from_numpy(jframe, device="cpu"),
        torch.from_numpy(K), float(bf), int(frame_id), sets=_reference_sets_for(int(frame_id)))
    assert got[0] and got[3] == ref_kf == jslam.trajectory.entries[30].ref_kf
    _assert_pose_within(got[1].numpy(), ref_T)
    assert _close_counts(_inliers(got[2]), _inliers(ref_mp))
