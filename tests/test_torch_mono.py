"""The monocular path on both packages (CPU): the two-view initializer
(`ops/twoview.py`), `match_mutual`, `models/initialization.py`'s monocular
half, the frame built without depth, and `SlamSystem(sensor=MONOCULAR)`.

The same numpy inputs, made from a seed, go through the JAX function and its
port. Tolerances:
- `_normalize`, `_score_h`, `_score_f`, `check_rt`: rtol 1e-5, inlier and
  good masks identical;
- `_dlt_h`, `_dlt_f`, `_fit_h_ls`, `_fit_f_ls`: equal up to scale and sign
  (Frobenius-normalized, largest entry positive) at 1e-4;
- `_decompose_e`, `_h_motions`: equal as sets at 1e-4;
- `initialize_two_view` with the reference's hypothesis sets: the same
  `success` and `used_h`; where it succeeds R within 0.05 deg, the t
  direction within 0.05 deg, `good` masks overlapping in >= 99%, points
  within 1e-3 relative;
- `match_mutual`, `match_for_initialization`: exact;
- `create_initial_map_mono`: integer fields exact, floats 1e-5;
- `SlamSystem` at 320x240 (fx=fy=400, 1000 features, bf=0) on 18 frames of
  `lateral_trajectory(100)` over the desk, once with the reference's sampler
  injected in place of the port's and once with the port's own draws from
  the same keys: the same initialization frame, the same tracked frames and
  keyframe count, poses within 2 mm (unit-median-depth gauge) / 0.05 deg.
  At fx=275 the desk's texture is too fine for the level-0 initialization
  search: neither package finds 70 matches between any two of the first ten
  frames, with 500, 700 or 1000 features.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.models import frontend as jfrontend
from orb_slam2v2_1_tpu.models import initialization as jinit
from orb_slam2v2_1_tpu.models import system as jsystem
from orb_slam2v2_1_tpu.models.map_state import MapState as JMapState
from orb_slam2v2_1_tpu.models.map_state import empty_map as jempty_map
from orb_slam2v2_1_tpu.ops import matching as jmatching
from orb_slam2v2_1_tpu.ops import orb as jorb
from orb_slam2v2_1_tpu.ops import twoview as jtv
from orb_slam2v2_1_tpu.utils import config as jconfig

from orb_slam2v2_1_tpu_torch.models import frontend, initialization, map_state, system, tracking
from orb_slam2v2_1_tpu_torch.ops import image, matching, orb, prng, twoview
from orb_slam2v2_1_tpu_torch.utils import config, synthetic

torch.set_num_threads(2)

KW = dict(fx=400.0, fy=400.0, cx=160.0, cy=120.0, width=320, height=240, n_features=1000,
          max_keyframes=16, max_map_points=4096, fps=10.0, bf=0.0, th_depth=40.0)
N_FRAMES = 18
K_NP = np.array([KW["fx"], KW["fy"], KW["cx"], KW["cy"]], np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def tframe(f):
    return tracking.frame_from_numpy({n: np.asarray(v) for n, v in zip(f._fields, f)}, device="cpu")


def up_to_sign(M):
    """Frobenius-normalized, the largest-magnitude entry made positive."""
    M = np.asarray(M, np.float64).reshape(M.shape[:-2] + (-1,))
    M = M / np.linalg.norm(M, axis=-1, keepdims=True)
    top = np.take_along_axis(M, np.argmax(np.abs(M), -1)[..., None], -1)
    return M * np.sign(top)


def assert_same_set(got, ref, atol):
    """Every row of `ref` has a row of `got` within atol, and back."""
    got = np.asarray(got).reshape(len(got), -1)
    ref = np.asarray(ref).reshape(len(ref), -1)
    d = np.abs(got[:, None, :] - ref[None, :, :]).max(-1)
    assert d.min(0).max() <= atol and d.min(1).max() <= atol, d.min(0)


def angle_deg(Ra, Rb):
    """Rotation angle between Ra and Rb from their chordal distance, which
    unlike the trace does not read the few-1e-6 departure from
    orthonormality of a decomposed homography's R as an angle."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return np.degrees(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0)))


# ---------------------------------------------------------------------------
# A synthetic two-view problem: points in front of both cameras, 0.5 px of
# pixel noise, 20% outliers, 10% invalid; "general" (a volume: F wins) and
# "planar" (a plane: H wins).


def two_view_problem(kind, seed=0, n=300):
    rng = np.random.default_rng(seed)
    if kind == "planar":
        P = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n), np.zeros(n)], -1)
        P[:, 2] = 3.0 + 0.3 * P[:, 0]
    else:
        P = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n), rng.uniform(2.0, 5.0, n)], -1)
    ang = np.deg2rad(4.0)
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    tr = np.array([-0.4, 0.05, 0.02])

    def proj(X):
        return np.stack([550 * X[:, 0] / X[:, 2] + 320, 550 * X[:, 1] / X[:, 2] + 240], -1)

    x1 = proj(P) + rng.normal(0, 0.5, (n, 2))
    x2 = proj(P @ R.T + tr) + rng.normal(0, 0.5, (n, 2))
    out = rng.uniform(size=n) < 0.2
    x2[out] = rng.uniform([0, 0], [640, 480], (int(out.sum()), 2))
    valid = rng.uniform(size=n) > 0.1
    K = np.array([550.0, 550.0, 320.0, 240.0], np.float32)
    return x1.astype(np.float32), x2.astype(np.float32), valid, K, R, tr


def ref_sets(valid, frame_key):
    """The reference's two (N_RANSAC, 8) draws for jax.random.key(frame_key)."""
    k_h, k_f = jax.random.split(jax.random.key(frame_key))
    v = jnp.asarray(valid)
    return tuple(np.array(jtv._sample_sets(k, v, jtv.N_RANSAC)) for k in (k_h, k_f))


@pytest.fixture(scope="module", params=["general", "planar"])
def problem(request):
    return two_view_problem(request.param)


def test_normalize_parity(problem):
    x1, _, valid, *_ = problem
    jxn, jT = jtv._normalize(jnp.asarray(x1), jnp.asarray(valid))
    xn, T = twoview._normalize(t(x1), t(valid))
    np.testing.assert_allclose(xn.numpy(), np.asarray(jxn), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=1e-5)


def _normalized(problem):
    x1, x2, valid, *_ = problem
    jx1n, jT1 = jtv._normalize(jnp.asarray(x1), jnp.asarray(valid))
    jx2n, jT2 = jtv._normalize(jnp.asarray(x2), jnp.asarray(valid))
    return [np.asarray(a) for a in (jx1n, jx2n, jT1, jT2)]


def test_dlt_parity(problem):
    """All 200 eight-point H and F solves of the reference's sets, up to
    scale and sign."""
    x1, x2, valid, *_ = problem
    x1n, x2n, _, _ = _normalized(problem)
    sets_h, sets_f = ref_sets(valid, 3)
    for jfn, fn, sets in ((jtv._dlt_h, twoview._dlt_h, sets_h), (jtv._dlt_f, twoview._dlt_f, sets_f)):
        ref = np.asarray(jax.vmap(jfn)(jnp.asarray(x1n[sets]), jnp.asarray(x2n[sets])))
        got = fn(t(x1n[sets]), t(x2n[sets])).numpy()
        np.testing.assert_allclose(up_to_sign(got), up_to_sign(ref), atol=1e-4)


def test_fit_ls_parity(problem):
    """The least-squares refits over a consensus set, up to scale and sign."""
    x1, x2, valid, *_ = problem
    x1n, x2n, T1, T2 = _normalized(problem)
    w = (valid & (np.arange(len(valid)) % 5 != 0)).astype(np.float32)
    args = [jnp.asarray(a) for a in (x1n, x2n, w, T1, T2)]
    targs = [t(a) for a in (x1n, x2n, w, T1, T2)]
    for jfn, fn in ((jtv._fit_h_ls, twoview._fit_h_ls), (jtv._fit_f_ls, twoview._fit_f_ls)):
        np.testing.assert_allclose(up_to_sign(fn(*targs).numpy()), up_to_sign(np.asarray(jfn(*args))), atol=1e-4)


def test_scores_parity(problem):
    """H and F scores and inlier masks of every hypothesis of the reference."""
    x1, x2, valid, *_ = problem
    x1n, x2n, T1, T2 = _normalized(problem)
    sets_h, sets_f = ref_sets(valid, 5)
    Hs = np.asarray(jax.vmap(lambda a, b: jnp.linalg.inv(T2) @ jtv._dlt_h(a, b) @ T1)(x1n[sets_h], x2n[sets_h]))
    Fs = np.asarray(jax.vmap(lambda a, b: T2.T @ jtv._dlt_f(a, b) @ T1)(x1n[sets_f], x2n[sets_f]))
    jx = [jnp.asarray(a) for a in (x1, x2, valid)]
    tx = [t(a) for a in (x1, x2, valid)]
    Hinv = np.linalg.inv(Hs.astype(np.float64)).astype(np.float32)
    js, jin = jax.vmap(lambda H, Hi: jtv._score_h(H, Hi, *jx))(Hs, Hinv)
    s, inl = twoview._score_h(t(Hs), t(Hinv), *tx)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jin))
    js, jin = jax.vmap(lambda F: jtv._score_f(F, *jx))(Fs)
    s, inl = twoview._score_f(t(Fs), *tx)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jin))
    assert int(inl.sum(-1).max()) > 100  # the hypotheses see the inliers


def test_motions_parity(problem):
    """The 4 motions of E and the 8 of H, as sets, on the problem's true
    essential matrix and homography."""
    x1, x2, valid, K, R, tr = problem
    Km = np.array([[K[0], 0, K[2]], [0, K[1], K[3]], [0, 0, 1.0]])
    tx = np.array([[0, -tr[2], tr[1]], [tr[2], 0, -tr[0]], [-tr[1], tr[0], 0]])
    E = (tx @ R).astype(np.float32)
    jR1, jR2, jt = jtv._decompose_e(jnp.asarray(E))
    R1, R2, te = twoview._decompose_e(t(E))
    assert_same_set(np.stack([R1.numpy(), R2.numpy()]), np.stack([np.asarray(jR1), np.asarray(jR2)]), 1e-4)
    assert_same_set(np.stack([te.numpy(), -te.numpy()]), np.stack([np.asarray(jt), -np.asarray(jt)]), 1e-4)
    n = np.array([0.0, 0.0, 1.0])
    H = (Km @ (R + np.outer(tr, n) / 3.0) @ np.linalg.inv(Km)).astype(np.float32)
    jRs, jts = jtv._h_motions(jnp.asarray(H), jnp.asarray(K))
    Rs, ts = twoview._h_motions(t(H), t(K))
    assert_same_set(np.concatenate([Rs.numpy().reshape(8, 9), ts.numpy()], -1),
                    np.concatenate([np.asarray(jRs).reshape(8, 9), np.asarray(jts)], -1), 1e-4)


def test_check_rt_parity(problem):
    """The audit of 12 candidate motions: counts and masks exact, parallax
    cosines rtol 1e-5. The good points come from the port's float32
    `triangulate`, held at 1e-4 of their norm (measured 1.5e-5); points seen
    under less than 2.5 deg of parallax, the initializer's own gate, at rtol
    1e-3: the wrong motion (R^T, -t) keeps 2-9 of them at 0.7-2 deg, where
    the two packages' float32 triangulations differ by up to 9.5e-4 relative
    (measured)."""
    x1, x2, valid, K, R, tr = problem
    rng = np.random.default_rng(1)
    Rs = np.stack([R, R.T] + [R] * 10).astype(np.float32)
    ts = np.stack([tr, -tr, tr * 2, -tr * 2] + [tr + rng.normal(0, 0.02, 3) for _ in range(8)]).astype(np.float32)
    jx = [jnp.asarray(a) for a in (x1, x2, valid, K)]
    jn, jX, jgood, jcos = jax.vmap(lambda R_, t_: jtv.check_rt(R_, t_, *jx))(Rs, ts)
    n, X, good, cos = twoview.check_rt(t(Rs), t(ts), *(t(a) for a in (x1, x2, valid, K)))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(good.numpy(), np.asarray(jgood))
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=1e-5)
    g = good.numpy()
    Xr = np.asarray(jX)
    o2 = -np.einsum("bji,bj->bi", Rs, ts)[:, None, :]
    cosp = np.sum(Xr * (Xr - o2), -1) / (np.linalg.norm(Xr, axis=-1) * np.linalg.norm(Xr - o2, axis=-1))
    wide = g & (cosp < twoview.PARALLAX_COS)
    rel = np.linalg.norm(X.numpy() - Xr, axis=-1) / np.linalg.norm(Xr, axis=-1)
    assert rel[wide].max() <= 1e-4 and rel[g].max() <= 1e-3, (rel[wide].max(), rel[g].max())
    assert wide.sum() >= 0.99 * g.sum() - 10
    assert n.numpy()[0] > 150


def assert_two_view_agree(got, ref):
    assert bool(got.success) == bool(ref.success)
    assert bool(got.used_h) == bool(ref.used_h)
    if not bool(ref.success):
        return
    assert angle_deg(got.R.numpy(), np.asarray(ref.R)) <= 0.05
    tg, tref = got.t.numpy().astype(np.float64), np.asarray(ref.t, np.float64)
    cos = tg @ tref / (np.linalg.norm(tg) * np.linalg.norm(tref))
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) <= 0.05
    g, jg = got.good.numpy(), np.asarray(ref.good)
    assert (g & jg).sum() >= 0.99 * max(g.sum(), jg.sum())
    both = g & jg
    Xg, Xr = got.points.numpy()[both], np.asarray(ref.points)[both]
    assert (np.linalg.norm(Xg - Xr, axis=-1) <= 1e-3 * np.linalg.norm(Xr, axis=-1)).all()


def test_initialize_two_view_synthetic(problem):
    """The whole initializer with the reference's hypothesis sets; the
    general scene takes F, the planar one H, and both recover the motion."""
    x1, x2, valid, K, R, tr = problem
    ref = jtv.initialize_two_view(*(jnp.asarray(a) for a in (x1, x2, valid, K)), jax.random.key(7))
    got = twoview.initialize_two_view(*(t(a) for a in (x1, x2, valid, K)), sets=ref_sets(valid, 7))
    assert_two_view_agree(got, ref)
    assert bool(got.success)
    assert angle_deg(got.R.numpy(), R) < 0.5


def test_sample_sets_valid_and_repeatable():
    valid = torch.from_numpy(np.random.default_rng(2).uniform(size=300) > 0.3)
    a = twoview.sample_sets(valid, prng.key(4))
    b = twoview.sample_sets(valid, prng.key(4))
    c = twoview.sample_sets(valid, prng.key(5))
    assert a.shape == (twoview.N_RANSAC, 8) and torch.equal(a, b) and not torch.equal(a, c)
    assert bool(valid[a].all())
    assert all(len(set(row.tolist())) == 8 for row in a)
    with pytest.raises(ValueError, match="key"):
        twoview.initialize_two_view(torch.zeros(300, 2), torch.zeros(300, 2), valid, torch.ones(4))


def test_parallax_constant():
    assert twoview.PARALLAX_COS == float(jnp.cos(jnp.deg2rad(2.5)))


# ---------------------------------------------------------------------------
# Real desk frames at the end-to-end configuration.


@pytest.fixture(scope="module")
def desk():
    cfg = config.SlamConfig(**KW)
    imgs, _, gt = synthetic.desk_frames(cfg, synthetic.lateral_trajectory(100)[:N_FRAMES], device="cpu")
    return imgs.numpy(), gt


@pytest.fixture(scope="module")
def desk_frames_ref(desk):
    """Frames 0-5 built by the reference without depth."""
    imgs, _ = desk
    jcfg = jconfig.SlamConfig(**KW)
    ocfg = jorb.OrbConfig(n_features=jcfg.n_features)
    return [jfrontend.build_frame_only(jnp.asarray(imgs[i]), jnp.zeros_like(jnp.asarray(imgs[i])),
                                       jnp.asarray(K_NP), jnp.zeros(5, jnp.float32), jnp.float32(0.0), jnp.int32(i),
                                       ocfg, False, jcfg.width, jcfg.height) for i in range(6)]


def test_frame_without_depth(desk, desk_frames_ref):
    """`build_frame_only(depth=None)`: depth and ur -1 everywhere, keypoints
    and descriptors as the reference builds them."""
    imgs, _ = desk
    f = frontend.build_frame_only(t(imgs[2]), None, t(K_NP), torch.zeros(5), 0.0, 2, orb.OrbConfig(n_features=1000),
                                  KW["width"], KW["height"])
    ref = desk_frames_ref[2]
    assert (f.depth == -1).all() and (f.ur == -1).all() and (f.mp == -1).all()
    np.testing.assert_array_equal(f.kp_valid.numpy(), np.asarray(ref.kp_valid))
    np.testing.assert_array_equal(f.level.numpy(), np.asarray(ref.level))
    np.testing.assert_allclose(f.xy.numpy(), np.asarray(ref.xy), atol=1e-4)
    flips = (f.desc_pm1.numpy() != np.asarray(ref.desc_pm1, np.float32)).mean()
    assert flips <= 1e-3


def test_match_mutual_parity(desk_frames_ref):
    a, b = desk_frames_ref[0], desk_frames_ref[1]
    mask = np.asarray(jmatching.window_mask(a.xy, b.xy, 40.0) & a.kp_valid[:, None] & b.kp_valid[None, :])
    ref = jmatching.match_mutual(a.desc_pm1, b.desc_pm1, jnp.asarray(mask))
    got = matching.match_mutual(t(np.asarray(a.desc_pm1, np.float32)), t(np.asarray(b.desc_pm1, np.float32)), t(mask))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    assert int(got.ok.sum()) > 50


@pytest.mark.parametrize("j", [1, 4])
def test_match_for_initialization_and_two_view(desk_frames_ref, j):
    """Frame 0 against frame j: the initialization matches exactly, then the
    two-view reconstruction with the reference's sets for key j (frame 1
    fails the gates, frame 4 succeeds with F)."""
    ref_m = jinit.match_for_initialization(desk_frames_ref[0], desk_frames_ref[j])
    f0, fj = tframe(desk_frames_ref[0]), tframe(desk_frames_ref[j])
    m = initialization.match_for_initialization(f0, fj)
    np.testing.assert_array_equal(m.ok.numpy(), np.asarray(ref_m.ok))
    np.testing.assert_array_equal(m.idx.numpy()[m.ok.numpy()], np.asarray(ref_m.idx)[np.asarray(ref_m.ok)])
    assert int(m.ok.sum()) >= 50
    ref = jtv.initialize_two_view(desk_frames_ref[0].xy, desk_frames_ref[j].xy[ref_m.idx], ref_m.ok,
                                  jnp.asarray(K_NP), jax.random.key(j))
    got = twoview.initialize_two_view(f0.xy, fj.xy[m.idx], m.ok, t(K_NP), sets=ref_sets(np.asarray(ref_m.ok), j))
    assert_two_view_agree(got, ref)
    assert bool(got.success) == (j == 4)


def test_create_initial_map_mono_parity(desk_frames_ref):
    """The two-keyframe map from the reference's two-view result: integer
    fields exact, floats 1e-5."""
    r0, r4 = desk_frames_ref[0], desk_frames_ref[4]
    m = jinit.match_for_initialization(r0, r4)
    res = jtv.initialize_two_view(r0.xy, r4.xy[m.idx], m.ok, jnp.asarray(K_NP), jax.random.key(4))
    assert bool(res.success)
    jstate, jT1, jkf0, jkf1, jn = jinit.create_initial_map_mono(jempty_map(16, 4096, 1000), r0, r4, m.idx, res,
                                                                jnp.asarray(K_NP))
    tres = twoview.TwoViewResult(*(t(np.asarray(x)) for x in res))
    state, T1, kf0, kf1, n = initialization.create_initial_map_mono(
        map_state.empty_map(16, 4096, 1000, device="cpu"), tframe(r0), tframe(r4), t(np.asarray(m.idx)), tres,
        t(K_NP))
    assert (int(kf0), int(kf1), int(n)) == (int(jkf0), int(jkf1), int(jn)) and int(n) >= 50
    np.testing.assert_allclose(T1.numpy(), np.asarray(jT1), atol=1e-5)
    ref = {name: np.asarray(v) for name, v in zip(JMapState._fields, jstate)}
    for name, v in map_state.to_numpy(state).items():
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(v, ref[name], rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(v, ref[name], err_msg=name)


def test_renormalize_scale_parity(rng):
    """The median-depth gauge on a map with two keyframes: 1e-5."""
    jstate = jempty_map(4, 64, 32)
    pos = np.concatenate([rng.uniform([-1, -1, 2], [1, 1, 6], (40, 3)), np.zeros((24, 3))]).astype(np.float32)
    kf_mp = np.full((4, 32), -1, np.int32)
    kf_mp[0, :30] = np.arange(30)
    kf_mp[0, 5] = -1
    pose = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    pose[1, :3, 3] = [0.3, 0.0, 0.1]
    pose[0, :3, 3] = [0.0, 0.1, 0.2]
    jstate = jstate._replace(mp_pos=jnp.asarray(pos), kf_mp=jnp.asarray(kf_mp), kf_pose=jnp.asarray(pose),
                             kf_kp_valid=jnp.ones((4, 32), bool))
    ref = jsystem._renormalize_scale(jstate)
    got = system._renormalize_scale(map_state.from_numpy(
        {n: np.asarray(v) for n, v in zip(JMapState._fields, jstate)}, device="cpu"))
    np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(ref.kf_pose), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.mp_pos.numpy(), np.asarray(ref.mp_pos), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# SlamSystem(sensor=MONOCULAR) end to end.


@pytest.fixture(scope="module")
def mono_runs(desk):
    imgs, gt = desk
    jslam = jsystem.SlamSystem(config=jconfig.SlamConfig(**KW), sensor=jsystem.Sensor.MONOCULAR)
    tslam = system.SlamSystem(config=config.SlamConfig(**KW), sensor=system.Sensor.MONOCULAR, device="cpu")
    initial_maps = []  # each package's map (numpy) just after its initialization

    def keep_initial_map(slam, initialize, to_numpy):
        def call(frame):
            ok = initialize(frame)
            if ok:
                initial_maps.append(to_numpy(slam.map))
            return ok
        return call

    jslam._initialize = keep_initial_map(jslam, jslam._initialize,
                                         lambda m: {n: np.asarray(v) for n, v in zip(JMapState._fields, m)})
    tslam._initialize = keep_initial_map(tslam, tslam._initialize, map_state.to_numpy)
    jout = [jslam.track_monocular(imgs[i], i * 0.1) for i in range(N_FRAMES)]
    real = twoview.sample_sets

    def reference_draw(valid, key, k=8):
        # The reference's own sampler on the same key (a half of the split
        # of jax.random.key(frame id)).
        jkey = jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32))
        return t(jtv._sample_sets(jkey, jnp.asarray(valid.numpy()), jtv.N_RANSAC, k))

    twoview.sample_sets = reference_draw
    try:
        tout = [tslam.track_monocular(imgs[i], i * 0.1) for i in range(N_FRAMES)]
    finally:
        twoview.sample_sets = real
    return jslam, tslam, jout, tout, initial_maps


def assert_poses_close(got, ref, mm=2.0, deg=0.05):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    centers = [np.stack([-p[:3, :3].T @ p[:3, 3] for p in x]) for x in (got, ref)]
    dc = np.linalg.norm(centers[0] - centers[1], axis=1)
    assert dc.max() <= mm * 1e-3, dc
    ang = [angle_deg(a[:3, :3], b[:3, :3]) for a, b in zip(got, ref)]
    assert max(ang) <= deg, ang


@pytest.fixture(scope="module")
def mono_run_own_draws(desk):
    """The port's SlamSystem on the same frames with its own draws."""
    imgs, _ = desk
    tslam = system.SlamSystem(config=config.SlamConfig(**KW), sensor=system.Sensor.MONOCULAR, device="cpu")
    return tslam, [tslam.track_monocular(imgs[i], i * 0.1) for i in range(N_FRAMES)]


def test_mono_system_parity(mono_runs):
    jslam, tslam, jout, tout, _ = mono_runs
    pattern = [o is not None for o in jout]
    assert [o is not None for o in tout] == pattern
    first = pattern.index(True)
    assert 0 < first < N_FRAMES - 4 and all(pattern[first:])
    assert tslam.n_kf_host == jslam.n_kf_host >= 3
    assert_poses_close([o for o in tout if o is not None], [o for o in jout if o is not None])
    assert tslam.stats()["n_frames"] == jslam.stats()["n_frames"] == N_FRAMES
    assert tslam.init_ref is None and tslam.loop_closer is not None and not tslam.loop_closer.fix_scale


def test_mono_system_parity_own_draws(mono_runs, mono_run_own_draws):
    """Without the injection: the port's two-view RANSAC draws the
    reference's sets from `prng.key(frame id)` itself, initializes on the
    reference's frame and tracks the reference's frames, and its run equals
    the injected one."""
    jslam, tslam_injected, jout, tout_injected, _ = mono_runs
    tslam, tout = mono_run_own_draws
    pattern = [o is not None for o in jout]
    assert [o is not None for o in tout] == pattern
    assert tslam.n_kf_host == jslam.n_kf_host >= 3
    assert_poses_close([o for o in tout if o is not None], [o for o in jout if o is not None])
    for a, b in zip(tout, tout_injected):
        assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))


def test_mono_system_initial_map_and_reset(mono_runs, desk):
    """The two-keyframe map right after initialization (two-view, joint BA,
    median-depth gauge): the same points, keyframe 1 within 2 mm / 0.05 deg
    of the reference's, points within 2 mm, keyframe 0's median depth 1. A
    frame without 100 keypoints does not become the initialization's first
    frame, a textured one does, and `reset` clears it."""
    ref, got = mono_runs[4]
    for name in ("kf_valid", "kf_frame_id", "kf_mp", "mp_valid", "n_mp", "n_kf"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    assert_poses_close(got["kf_pose"][:2], ref["kf_pose"][:2])
    live = ref["mp_valid"]
    assert np.linalg.norm(got["mp_pos"][live] - ref["mp_pos"][live], axis=-1).max() <= 2e-3
    mp0 = got["kf_mp"][0]
    has = (mp0 >= 0) & got["kf_kp_valid"][0]
    z = got["mp_pos"][mp0[has]] @ got["kf_pose"][0, 2, :3] + got["kf_pose"][0, 2, 3]
    assert abs(float(np.median(z)) - 1.0) <= 1e-5
    slam = system.SlamSystem(config=config.SlamConfig(**KW), sensor=system.Sensor.MONOCULAR, device="cpu")
    assert slam.track_monocular(np.full((KW["height"], KW["width"]), 128.0, np.float32), 0.0) is None
    assert slam.init_ref is None and slam.state.name == "NOT_INITIALIZED"
    slam.track_monocular(desk[0][0], 0.1)
    assert slam.init_ref is not None and slam.init_ref.frame_id == 1
    slam.reset()
    assert slam.init_ref is None and slam.n_resets == 1 and slam.state.name == "NO_IMAGES_YET"


# ---------------------------------------------------------------------------
# The ORB patch on an undersized pyramid level.


@pytest.mark.parametrize("h, w", [(120, 160), (240, 320)])
def test_orb_on_undersized_level(h, w):
    """At 160x120 with 8 levels the top level is 33x45 and the ORB gather 39
    px: the reference's `lax.dynamic_slice` raises TypeError, and so does the
    port. At 320x240 neither raises and both give the same keypoints."""
    img = np.random.default_rng(3).uniform(0, 255, (h, w)).astype(np.float32)
    if h == 120:
        with pytest.raises(TypeError):
            jorb.extract_orb(jnp.asarray(img), jorb.OrbConfig(n_features=500))
        with pytest.raises(TypeError, match="39x39 window is larger than the 33x45 image"):
            orb.extract_orb(t(img), orb.OrbConfig(n_features=500))
        return
    ref = jorb.extract_orb(jnp.asarray(img), jorb.OrbConfig(n_features=500))
    got = orb.extract_orb(t(img), orb.OrbConfig(n_features=500))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(ref.xy), atol=1e-4)


def test_gather_windows_fits_or_raises():
    img = torch.arange(20 * 30, dtype=torch.float32).reshape(20, 30)
    win = image.gather_windows(img, torch.tensor([-3, 0, 15]), torch.tensor([0, 25, 4]), 20, 6)
    assert win.shape == (3, 20, 6)
    assert torch.equal(win[1], img[:, 24:30]) and torch.equal(win[2], img[:, 4:10])
    for h, w in ((21, 6), (5, 31)):
        with pytest.raises(TypeError, match=f"{h}x{w} window"):
            image.gather_windows(img, torch.tensor([0]), torch.tensor([0]), h, w)
