"""The port's copy of `jax.random` (`ops/prng.py`) against JAX, on the CPU.

`key`, `split`, `fold_in`, `bits32` and `uniform` must equal `jax.random`'s
`key_data`, `split`, `fold_in`, `bits(..., jnp.uint32)` and `uniform` bit for
bit; the hypothesis sets drawn from a key must equal the JAX package's three
samplers exactly (`ops/pnp.py _sample_sets`, the Sim3 draw of
`ops/sim3solver.py sim3_ransac`, `ops/twoview.py _sample_sets` after a
split) on a seeded sweep of masks, from no valid entry to all; and
`pnp_ransac`, `sim3_ransac` and `initialize_two_view` given only a key must
give what the port gives with the reference's sets injected, bit for bit,
and so the reference's results at the tolerances of the injected-set tests:
inlier masks and counts exact, S12 1e-4, the two-view motion 0.05 deg.

Seeds: 0, 1, 12, 2**31 - 1, 2**31 + 5 and the reference's key formulas
(`frame_id * 97 + kf` for relocalization, `kf_id * 131 + cand` for loop
closing).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.ops import pnp as jpnp
from orb_slam2v2_1_tpu.ops import sim3solver as js3
from orb_slam2v2_1_tpu.ops import twoview as jtv

from orb_slam2v2_1_tpu_torch.ops import pnp, prng, sim3solver, twoview

torch.set_num_threads(2)

SEEDS = [0, 1, 12, 2**31 - 1, 2**31 + 5, 40 * 97 + 3, 16 * 131 + 0]
SHAPES = [(1,), (3, 5), (256, 7), (200, 1000), (256, 4096)]
# (N, valid count): none valid, fewer than every sampler's k, exactly k, a
# share, all valid; at the paths' sizes and below.
MASKS = [(8, 0), (8, 8), (12, 2), (40, 5), (40, 40), (300, 7), (300, 60), (1000, 240), (1000, 1000),
         (2000, 900), (3000, 30)]


def key_words(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


def mask(n, n_valid, seed):
    valid = np.zeros(n, bool)
    valid[np.random.default_rng(seed).choice(n, n_valid, replace=False)] = True
    return valid


def test_threefry_is_partitionable():
    """`ops/prng.py` follows the partitionable layout of `bits` and `split`;
    another setting of the installed JAX would be another stream."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    k, jk = prng.key(seed), jax.random.key(seed)
    assert k == key_words(jk)
    assert prng.split(k) == tuple(key_words(s) for s in jax.random.split(jk))
    assert prng.split(k, 5) == tuple(key_words(s) for s in jax.random.split(jk, 5))
    for data in (0, 7, 2**31 + 1, 2**32 - 1):
        assert prng.fold_in(k, data) == key_words(jax.random.fold_in(jk, data))


def test_key_range():
    assert prng.key(2**32 - 1) == (0, 2**32 - 1)
    for bad in (-1, 2**32):
        with pytest.raises(ValueError):
            prng.key(bad)
        with pytest.raises(ValueError):
            prng.fold_in(prng.key(0), bad)


@pytest.mark.parametrize("shape", SHAPES)
def test_bits32(shape):
    for seed in SEEDS:
        jk = jax.random.key(seed)
        for k, jkk in ((prng.key(seed), jk), (prng.split(prng.key(seed))[1], jax.random.split(jk)[1]),
                       (prng.fold_in(prng.key(seed), 9), jax.random.fold_in(jk, 9))):
            got = prng.bits32(k, shape)
            assert got.dtype == torch.int64 and tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.bits(jkk, shape, jnp.uint32)))


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform(shape):
    tiny = float(np.finfo(np.float32).tiny)  # the bounds of the reference's Gumbel draw
    for seed in SEEDS:
        for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-1.0, 2.5)):
            got = prng.uniform(prng.key(seed), shape, minval=lo, maxval=hi).numpy()
            ref = np.asarray(jax.random.uniform(jax.random.key(seed), shape, jnp.float32, lo, hi))
            np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("n, n_valid", MASKS)
def test_sets_equal_the_reference_samplers(n, n_valid):
    """The sets of all three samplers, for the reference's key formulas:
    exact, including the order within a set and the invalid entries a set
    takes (in index order) when fewer than k are valid."""
    for i, seed in enumerate(SEEDS):
        valid = mask(n, n_valid, seed % 1000 + i)
        tv, jv = torch.from_numpy(valid), jnp.asarray(valid)
        jk = jax.random.key(seed)
        if n >= pnp.SAMPLE:
            ref = np.asarray(jpnp._sample_sets(jk, jv, jpnp.N_HYP, jpnp.SAMPLE))
            np.testing.assert_array_equal(pnp.sample_sets(tv, prng.key(seed)).numpy(), ref)
        g = jnp.where(jv[None, :], jax.random.gumbel(jk, (js3.N_HYP, n)), -jnp.inf)  # sim3solver.py:80-82
        ref = np.asarray(jax.lax.top_k(g, 3)[1])
        np.testing.assert_array_equal(sim3solver.hypothesis_sets(tv, prng.key(seed)).numpy(), ref)
        if n >= 8:
            for k, jkk in zip(prng.split(prng.key(seed)), jax.random.split(jk)):
                ref = np.asarray(jtv._sample_sets(jkk, jv, jtv.N_RANSAC))
                np.testing.assert_array_equal(twoview.sample_sets(tv, k).numpy(), ref)


def test_sets_valid_distinct_and_on_the_mask_device():
    valid = torch.from_numpy(mask(300, 200, 2))
    sets = pnp.sample_sets(valid, prng.key(4))
    assert sets.dtype == torch.int64 and sets.device == valid.device
    assert bool(valid[sets].all()) and (sets.sort(dim=1)[0].diff(dim=1) > 0).all()
    assert torch.equal(sets, pnp.sample_sets(valid, prng.key(4)))
    assert not torch.equal(sets, pnp.sample_sets(valid, prng.key(5)))


# ---------------------------------------------------------------------------
# the three RANSACs given a key only


K_NP = np.array([300.0, 300.0, 160.0, 120.0], np.float32)


def _rotation(rng, sigma):
    ang = rng.normal(0, sigma, 3)
    th = np.linalg.norm(ang)
    k = ang / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _project(pc, K):
    return np.stack([K[0] * pc[:, 0] / pc[:, 2] + K[2], K[1] * pc[:, 1] / pc[:, 2] + K[3]], -1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_ransac_key_only(seed):
    """300 points 2-6 m ahead, 60 replaced by random pixels, exact
    otherwise; key `97 * 40 + seed` as relocalization seeds it."""
    rng = np.random.default_rng(seed)
    n = 300
    R, t = _rotation(rng, 0.2), rng.normal(0, 0.3, 3)
    pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 6, n)], -1)
    pw = ((pc - t) @ R).astype(np.float32)
    uv = _project(pc, K_NP)
    uv[rng.choice(n, 60, replace=False)] = rng.uniform([0, 0], [320, 240], (60, 2))
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.uniform(size=n) > 0.05
    args = (pw, uv.astype(np.float32), inv_s2, valid, K_NP)
    seed_key = 97 * 40 + seed
    ref = jpnp.pnp_ransac(*(jnp.asarray(a) for a in args), jax.random.key(seed_key))
    got = pnp.pnp_ransac(*(torch.from_numpy(a) for a in args), key=prng.key(seed_key))
    sets = jpnp._sample_sets(jax.random.key(seed_key), jnp.asarray(valid), jpnp.N_HYP, jpnp.SAMPLE)
    injected = pnp.pnp_ransac(*(torch.from_numpy(a) for a in args), sets=torch.from_numpy(np.array(sets)))
    for a, b in zip(got, injected):
        assert torch.equal(a, b)
    assert bool(got.success) and bool(ref.success)
    assert int(got.n_inliers) == int(ref.n_inliers) >= 200
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(got.Tcw.numpy()[:3, 3], t, atol=1e-3)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_ransac_key_only(fix_scale):
    """160 matched points of two cameras 3-7 m ahead, 0.5 px of noise, 30
    gross outliers; key `16 * 131 + 0` as loop closing seeds it."""
    rng = np.random.default_rng(3)
    n = 160
    p2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 7, n)], -1)
    s = 1.0 if fix_scale else 1.08
    R, t = _rotation(rng, 0.1), np.array([0.3, -0.1, 0.2])
    p1 = s * p2 @ R.T + t
    uv1 = _project(p1, K_NP) + rng.normal(0, 0.5, (n, 2))
    uv2 = _project(p2, K_NP) + rng.normal(0, 0.5, (n, 2))
    p1[:30] += rng.normal(0, 1.0, (30, 3))
    valid = rng.uniform(size=n) > 0.1
    sig = 1.2 ** (2 * rng.integers(0, 4, (2, n)))
    args = [a.astype(np.float32) for a in (p1, p2, uv1, uv2, sig[0], sig[1])] + [valid, K_NP]
    seed_key = 16 * 131
    ref = js3.sim3_ransac(*(jnp.asarray(a) for a in args), jax.random.key(seed_key), fix_scale=fix_scale)
    got = sim3solver.sim3_ransac(*(torch.from_numpy(a) for a in args), key=prng.key(seed_key), fix_scale=fix_scale)
    sets = sim3solver.hypothesis_sets(torch.from_numpy(valid), prng.key(seed_key))
    injected = sim3solver.sim3_ransac(*(torch.from_numpy(a) for a in args), sets=sets, fix_scale=fix_scale)
    for a, b in zip(got, injected):
        assert torch.equal(a, b)
    assert bool(got.success) and bool(ref.success)
    np.testing.assert_allclose(got.S12.numpy(), np.asarray(ref.S12), atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) >= 100


def _angle_deg(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return np.degrees(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0)))


@pytest.mark.parametrize("kind", ["general", "planar"])
def test_initialize_two_view_key_only(kind):
    """300 points seen from two cameras 0.4 m apart (a volume: F wins; a
    plane: H wins), 0.5 px of noise, 20% outliers, 10% invalid; the key of
    frame 12, split into H's and F's as the reference splits it."""
    rng = np.random.default_rng(0)
    n = 300
    P = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n), rng.uniform(2.0, 5.0, n)], -1)
    if kind == "planar":
        P[:, 2] = 3.0 + 0.3 * P[:, 0]
    ang = np.deg2rad(4.0)
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    K = np.array([550.0, 550.0, 320.0, 240.0], np.float32)
    x1 = _project(P, K) + rng.normal(0, 0.5, (n, 2))
    x2 = _project(P @ R.T + np.array([-0.4, 0.05, 0.02]), K) + rng.normal(0, 0.5, (n, 2))
    out = rng.uniform(size=n) < 0.2
    x2[out] = rng.uniform([0, 0], [640, 480], (int(out.sum()), 2))
    valid = rng.uniform(size=n) > 0.1
    args = (x1.astype(np.float32), x2.astype(np.float32), valid, K)
    ref = jtv.initialize_two_view(*(jnp.asarray(a) for a in args), jax.random.key(12))
    got = twoview.initialize_two_view(*(torch.from_numpy(a) for a in args), key=prng.key(12))
    sets = tuple(np.asarray(jtv._sample_sets(k, jnp.asarray(valid), jtv.N_RANSAC)) for k in jax.random.split(
        jax.random.key(12)))
    injected = twoview.initialize_two_view(*(torch.from_numpy(a) for a in args), sets=sets)
    for a, b in zip(got, injected):
        assert torch.equal(a, b)
    assert bool(got.success) and bool(ref.success)
    assert bool(got.used_h) == bool(ref.used_h) == (kind == "planar")
    assert _angle_deg(got.R.numpy(), np.asarray(ref.R)) <= 0.05
    tg, tr = got.t.numpy().astype(np.float64), np.asarray(ref.t, np.float64)
    cos = tg @ tr / (np.linalg.norm(tg) * np.linalg.norm(tr))
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) <= 0.05
    assert _angle_deg(got.R.numpy(), R) < 0.5
