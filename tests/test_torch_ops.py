"""Parity of the PyTorch port's ops against the JAX package (CPU).

Inputs are made with numpy from a seed and handed to both packages; each
test states its tolerance and why. The JAX side runs as its own tests run it
on the CPU: `pallas_kernels.enabled()` is False there, so the reference's
`suppressed_score` and `match_projection` take their XLA twins.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.ops import ba as jba
from orb_slam2v2_1_tpu.ops import fast as jfast
from orb_slam2v2_1_tpu.ops import hamming as jham
from orb_slam2v2_1_tpu.ops import image as jimage
from orb_slam2v2_1_tpu.ops import lie as jlie
from orb_slam2v2_1_tpu.ops import matching as jmatch
from orb_slam2v2_1_tpu.ops import orb as jorb
from orb_slam2v2_1_tpu.ops import pallas_kernels
from orb_slam2v2_1_tpu.ops import projection as jproj
from orb_slam2v2_1_tpu.ops import triangulate as jtri
from orb_slam2v2_1_tpu.ops import undistort as jund

from orb_slam2v2_1_tpu_torch.ops import ba, fast, hamming, image, lie, matching, orb
from orb_slam2v2_1_tpu_torch.ops import projection, triangulate, undistort
from orb_slam2v2_1_tpu_torch.ops.topk import scatter_last, stable_topk

torch.set_num_threads(2)


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def N(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def random_textured(rng, h, w):
    """Smooth random texture with strong corners (numpy, float32)."""
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(rng.standard_normal((h, w)), 2.0) * 400 + 128
    return np.clip(img, 0, 255).astype(np.float32)


# ---------------------------------------------------------------------------
# lie / projection / undistort: float32 math in the same order, so 1e-5.
# ---------------------------------------------------------------------------


class TestLie:
    def test_se3_exp_log_parity(self, rng):
        xi = (rng.normal(size=(64, 6)) * 0.8).astype(np.float32)
        xi[:4] *= 1e-6  # small-angle branches
        np.testing.assert_allclose(N(lie.se3_exp(T(xi))), np.asarray(jlie.se3_exp(jnp.asarray(xi))), atol=1e-5)
        Tm = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
        np.testing.assert_allclose(N(lie.se3_log(T(Tm))), np.asarray(jlie.se3_log(jnp.asarray(Tm))), atol=1e-5)

    def test_so3_log_near_pi_parity(self):
        axis = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
        phi = ((np.pi - 1e-4) * axis).astype(np.float32)
        R = np.asarray(jlie.so3_exp(jnp.asarray(phi)))
        np.testing.assert_allclose(N(lie.so3_log(T(R))), np.asarray(jlie.so3_log(jnp.asarray(R))), atol=1e-5)

    def test_quat_orthonormalize_inverse_transform(self, rng):
        q = rng.normal(size=(16, 4)).astype(np.float32)
        R = np.asarray(jlie.quat_to_rot(jnp.asarray(q)))
        np.testing.assert_allclose(N(lie.quat_to_rot(T(q))), R, atol=1e-5)
        np.testing.assert_allclose(N(lie.rot_to_quat(T(R))), np.asarray(jlie.rot_to_quat(jnp.asarray(R))), atol=1e-5)
        Tm = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(size=(16, 6)).astype(np.float32))))
        noisy = (Tm + rng.normal(size=Tm.shape) * 1e-4).astype(np.float32)
        np.testing.assert_allclose(N(lie.orthonormalize(T(noisy))), np.asarray(jlie.orthonormalize(jnp.asarray(noisy))), atol=1e-5)
        np.testing.assert_allclose(N(lie.se3_inverse(T(Tm))), np.asarray(jlie.se3_inverse(jnp.asarray(Tm))), atol=1e-5)
        pts = rng.normal(size=(16, 10, 3)).astype(np.float32)
        np.testing.assert_allclose(
            N(lie.transform_points(T(Tm), T(pts))),
            np.asarray(jlie.transform_points(jnp.asarray(Tm), jnp.asarray(pts))), atol=1e-5)

    def test_properties(self, rng):
        """The properties of tests/test_lie.py that the slice relies on."""
        phi = rng.normal(size=(64, 3)).astype(np.float32)
        phi *= (rng.uniform(0.01, 3.0, size=(64, 1)) / np.linalg.norm(phi, axis=-1, keepdims=True)).astype(np.float32)
        np.testing.assert_allclose(N(lie.so3_log(lie.so3_exp(T(phi)))), phi, atol=2e-4)
        R = N(lie.so3_exp(T(phi)))
        np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), np.broadcast_to(np.eye(3), R.shape), atol=1e-5)
        xi = (rng.normal(size=(64, 6)) * 0.8).astype(np.float32)
        np.testing.assert_allclose(N(lie.se3_log(lie.se3_exp(T(xi)))), xi, atol=3e-4)
        Tm = lie.se3_exp(T(xi))
        np.testing.assert_allclose(N(Tm @ lie.se3_inverse(Tm)), np.broadcast_to(np.eye(4), (64, 4, 4)), atol=1e-5)
        np.testing.assert_allclose(N(lie.so3_exp(torch.zeros(3))), np.eye(3), atol=1e-6)


class TestProjectionUndistort:
    def test_project_and_residuals(self, rng):
        Tm = np.asarray(jlie.se3_exp(jnp.asarray((rng.normal(size=6) * 0.1).astype(np.float32))))
        pw = (rng.normal(size=(20, 3)) + [0, 0, 4]).astype(np.float32)
        K = np.array([500.0, 510.0, 320.0, 240.0], np.float32)
        np.testing.assert_allclose(N(projection.project(T(Tm), T(pw), T(K))),
                                   np.asarray(jproj.project(jnp.asarray(Tm), jnp.asarray(pw), jnp.asarray(K))), atol=1e-3)
        np.testing.assert_allclose(N(projection.project_stereo(T(Tm), T(pw), T(K), 40.0)),
                                   np.asarray(jproj.project_stereo(jnp.asarray(Tm), jnp.asarray(pw), jnp.asarray(K), 40.0)), atol=1e-3)
        obs = rng.uniform(0, 600, 3).astype(np.float32)
        got = projection.stereo_residual_jac(T(Tm), T(pw[0]), T(obs), T(K), 40.0)
        ref = jproj.stereo_residual_jac(jnp.asarray(Tm), jnp.asarray(pw[0]), jnp.asarray(obs), jnp.asarray(K), 40.0)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(N(g), np.asarray(r), rtol=1e-5, atol=1e-3)
        got = projection.mono_residual_jac(T(Tm), T(pw[0]), T(obs[:2]), T(K))
        ref = jproj.mono_residual_jac(jnp.asarray(Tm), jnp.asarray(pw[0]), jnp.asarray(obs[:2]), jnp.asarray(K))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(N(g), np.asarray(r), rtol=1e-5, atol=1e-3)
        chi2 = np.concatenate([[0.0, 5.991], rng.uniform(0, 20, 30)]).astype(np.float32)
        np.testing.assert_allclose(N(projection.huber_weight(T(chi2), 5.991)),
                                   np.asarray(jproj.huber_weight(jnp.asarray(chi2), 5.991)), rtol=1e-6)

    def test_undistort(self, rng):
        uv = rng.uniform(0, 640, (50, 2)).astype(np.float32)
        K = np.array([517.3, 516.5, 318.6, 255.3], np.float32)
        dist = np.array([0.26, -0.95, -0.005, 0.0026, 1.16], np.float32)
        np.testing.assert_allclose(N(undistort.undistort_points(T(uv), T(K), T(dist))),
                                   np.asarray(jund.undistort_points(jnp.asarray(uv), jnp.asarray(K), jnp.asarray(dist))),
                                   atol=1e-3)


# ---------------------------------------------------------------------------
# hamming: integer math, exact.
# ---------------------------------------------------------------------------


class TestHamming:
    def test_word_converters_roundtrip(self, rng):
        packed = rng.integers(0, 2**32, (33, 8), dtype=np.uint32)
        words = hamming.words_from_uint32(packed)
        assert words.dtype == np.int32
        np.testing.assert_array_equal(hamming.words_to_uint32(torch.from_numpy(words)), packed)
        # Bit b of word w is descriptor bit 32w+b, as the reference packs it.
        np.testing.assert_array_equal(N(hamming.unpack_pm1(torch.from_numpy(words))),
                                      np.asarray(jham.unpack_pm1(jnp.asarray(packed))).astype(np.float32))

    def test_popcount_distances_exact(self, rng):
        a = rng.integers(0, 2**32, (40, 8), dtype=np.uint32)
        b = rng.integers(0, 2**32, (40, 8), dtype=np.uint32)
        a[0] = 0xFFFFFFFF
        b[0] = 0
        wa, wb = torch.from_numpy(hamming.words_from_uint32(a)), torch.from_numpy(hamming.words_from_uint32(b))
        np.testing.assert_array_equal(N(hamming.popcount32(wa)), np.asarray(jham.popcount32(jnp.asarray(a))))
        np.testing.assert_array_equal(N(hamming.distance_packed(wa, wb)),
                                      np.asarray(jham.distance_packed(jnp.asarray(a), jnp.asarray(b))))
        np.testing.assert_array_equal(
            N(hamming.distance_matrix(hamming.unpack_pm1(wa), hamming.unpack_pm1(wb))),
            np.asarray(jham.distance_matrix(jham.unpack_pm1(jnp.asarray(a)), jham.unpack_pm1(jnp.asarray(b)))))

    def test_pack_bits_inverts_unpack(self, rng):
        bits = rng.uniform(size=(7, 256)) > 0.5
        words = hamming.pack_bits(torch.from_numpy(bits))
        np.testing.assert_array_equal(N(hamming.unpack_pm1(words)) > 0, bits)


# ---------------------------------------------------------------------------
# image / fast / orb
# ---------------------------------------------------------------------------


class TestPyramid:
    def test_build_pyramid(self, rng):
        """atol 1e-2: the port applies jax.image.resize's own weight matrices
        as two float32 products, so levels differ only in summation order."""
        img = random_textured(rng, 120, 160)
        got = image.build_pyramid(T(img), 8, 1.2)
        ref = jimage.build_pyramid(jnp.asarray(img), 8, 1.2)
        for g, r in zip(got, ref):
            assert tuple(g.shape) == r.shape
            np.testing.assert_allclose(N(g), np.asarray(r), atol=1e-2)
        assert image.pyramid_shapes(480, 640, 8, 1.2) == jimage.pyramid_shapes(480, 640, 8, 1.2)
        np.testing.assert_allclose(N(image._gauss_kernel(9, 3.0)), np.asarray(jimage._gauss_kernel(9, 3.0)), atol=1e-7)


class TestFast:
    @pytest.mark.parametrize("shape", [(97, 200), (64, 128), (13, 45)])
    def test_fast_score_nms_exact(self, rng, shape):
        """Exact: subtraction, min and max only, with the same borders."""
        img = rng.uniform(0, 255, shape).astype(np.float32)
        s = fast.fast_score(T(img))
        np.testing.assert_array_equal(N(s), np.asarray(jfast.fast_score(jnp.asarray(img))))
        np.testing.assert_array_equal(N(fast.nms3(s)), np.asarray(jfast.nms3(jnp.asarray(N(s)))))
        np.testing.assert_array_equal(N(fast.suppressed_score(T(img))),
                                      np.asarray(jfast.suppressed_score(jnp.asarray(img))))

    def test_plain_matches_pallas_kernel_inside_border(self, rng, monkeypatch):
        """The TPU kernel in interpret mode zero-pads and wraps columns, so it
        agrees with the plain version inside the 19-px border only (atol 1e-4,
        as tests/test_pallas.py holds it)."""
        monkeypatch.setenv("ORB_TPU_PALLAS_INTERPRET", "1")
        img = rng.uniform(0, 255, (97, 200)).astype(np.float32)
        got = N(fast.suppressed_score(T(img)))
        ref = np.asarray(pallas_kernels.fast_score_nms(jnp.asarray(img)))
        b = 19
        np.testing.assert_allclose(got[b:-b, b:-b], ref[b:-b, b:-b], atol=1e-4)

    @pytest.mark.parametrize("shape", [(120, 150), (97, 133)])
    def test_select_keypoints_exact(self, rng, shape):
        """Exact at two ragged shapes, ties and empty cells included: scores
        are quantized to few values so cells tie, and a blank band leaves
        cells empty."""
        score = np.round(rng.uniform(0, 40, shape) / 8) * 8
        score[40:75, 30:90] = 0.0
        score = score.astype(np.float32)
        for n, suppress in ((60, True), (150, False), (200, False)):
            gy, gr, gv = fast.select_keypoints(T(score), n, suppress=suppress)
            ry, rr, rv = jfast.select_keypoints(jnp.asarray(score), n, suppress=suppress)
            np.testing.assert_array_equal(N(gy), np.asarray(ry))
            np.testing.assert_array_equal(N(gr), np.asarray(rr))
            np.testing.assert_array_equal(N(gv), np.asarray(rv))
        assert fast.level_feature_counts(1000, 8, 1.2) == jfast.level_feature_counts(1000, 8, 1.2)

    @pytest.mark.parametrize("shape", [(120, 150), (97, 133)])
    def test_select_keypoints_split_exact(self, rng, shape):
        """`rank_cells` (what kernel 1's epilogue computes on the card) then
        `select_from_cells` (what stays in PyTorch) is `select_keypoints`, and
        equals the reference's, with thresholds other than the defaults."""
        score = np.round(rng.uniform(0, 40, shape) / 8) * 8
        score[:, 60:100] = 0.0
        score = score.astype(np.float32)
        kw = dict(cell=16, border=21, threshold=24.0, min_threshold=8.0)
        best, arg = fast.rank_cells(T(score), **kw)
        assert best.shape == arg.shape == (-(-shape[0] // 16), -(-shape[1] // 16))
        assert best.dtype == torch.float32 and arg.dtype == torch.int64
        got = fast.select_from_cells(best, arg, 70, 16)
        whole = fast.select_keypoints(T(score), 70, suppress=False, **kw)
        ref = jfast.select_keypoints(jnp.asarray(score), 70, suppress=False, **kw)
        for g, w, r in zip(got, whole, ref):
            np.testing.assert_array_equal(N(g), N(w))
            np.testing.assert_array_equal(N(g), np.asarray(r))

    def test_rank_cells_rule(self, rng):
        """The cell reduction spelled out in numpy: the first maximal entry
        in row-major order wins a tie, an empty cell gives (0, index 0), and
        the ragged edge counts as zeros."""
        score = (np.round(rng.uniform(0, 40, (70, 90)) / 10) * 10).astype(np.float32)
        score[16:48, 16:48] = 0.0  # four empty cells
        best, arg = fast.rank_cells(T(score), cell=16, border=3, threshold=20.0, min_threshold=7.0)
        h, w = score.shape
        rank = np.where(score >= 7.0, score, 0.0).astype(np.float32)
        rank[:3] = rank[-3:] = 0.0
        rank[:, :3] = rank[:, -3:] = 0.0
        rank = np.where(rank >= 20.0, rank + np.float32(1e4), rank).astype(np.float32)
        padded = np.zeros((80, 96), np.float32)
        padded[:h, :w] = rank
        for cy in range(5):
            for cx in range(6):
                blk = padded[cy * 16:(cy + 1) * 16, cx * 16:(cx + 1) * 16].reshape(-1)
                assert float(best[cy, cx]) == blk.max()
                assert int(arg[cy, cx]) == int(np.flatnonzero(blk == blk.max())[0])
        assert float(best[1, 1]) == 0.0 and int(arg[1, 1]) == 0

    def test_pyramid_form_equals_per_level(self, rng):
        """`suppressed_cells_pyramid` over the levels of a pyramid equals the
        per-level form `rank_cells(suppressed_score(level))`."""
        img = random_textured(rng, 120, 160)
        levels = image.build_pyramid(T(img), 4, 1.2)
        got = fast.suppressed_cells_pyramid(levels, cell=16, border=19, threshold=20.0, min_threshold=7.0)
        assert got.best.shape == got.arg.shape == (len(levels), 8 * 10)
        for l, lvl in enumerate(levels):
            best, arg = got.level(l)
            rb, ra = fast.rank_cells(fast.suppressed_score(lvl), 16, 19, 20.0, 7.0)
            assert torch.equal(best, rb) and torch.equal(arg, ra)
            assert float(best.max()) > 1e4  # the texture has strong corners
            assert not got.best[l, best.numel():].any()

    def test_pyramid_selection_equals_per_level(self, rng):
        """`select_from_pyramid_cells` (one sort for all levels) equals
        `select_from_cells` level by level, exactly: ties, empty cells, and a
        level that is asked for more keypoints than it has cells."""
        levels = [T((np.round(rng.uniform(0, 40, shape) / 8) * 8).astype(np.float32))
                  for shape in ((120, 150), (97, 133), (64, 64))]
        counts = [50, 30, 40]  # the last level has 16 cells
        kw = dict(cell=16, border=19, threshold=20.0, min_threshold=7.0)
        per_level = [fast.rank_cells(lvl, **kw) for lvl in levels]
        stride = max(max(b.numel() for b, _ in per_level), max(counts))
        best = torch.zeros((3, stride))
        arg = torch.full((3, stride), 77, dtype=torch.int64)  # padding of arg is never read
        for l, (b, a) in enumerate(per_level):
            best[l, :b.numel()], arg[l, :a.numel()] = b.reshape(-1), a.reshape(-1)
        cells = fast.PyramidCells(best, arg, tuple(tuple(b.shape) for b, _ in per_level))
        got = fast.select_from_pyramid_cells(cells, counts, 16)
        for (b, a), n, g in zip(per_level, counts, got):
            for x, y in zip(g, fast.select_from_cells(b, a, n, 16)):
                assert x.dtype == y.dtype and torch.equal(x, y)
        with pytest.raises(ValueError, match="rows"):
            fast.select_from_pyramid_cells(cells, [stride + 1, 1, 1], 16)


class TestOrb:
    def test_brief_tables_exact(self):
        np.testing.assert_array_equal(orb._PATTERN, np.asarray(jorb._PATTERN))
        np.testing.assert_array_equal(orb._DISC, np.asarray(jorb._DISC))
        S = orb._make_select_matrices(orb._PATTERN)
        np.testing.assert_array_equal(S, np.asarray(jorb._SELECT))
        # Each select column holds exactly one 1, at the tap index the port gathers.
        assert np.all(S.sum(0) == 1)
        np.testing.assert_array_equal(orb._TAP_IDX.reshape(-1), np.argmax(S, axis=0))

    def test_brief_descriptors_exact(self, rng):
        """Exact on the same blurred patches: the taps are gathered values and
        the bits plain comparisons."""
        patches = rng.uniform(0, 255, (50, 31, 31)).astype(np.float32)
        angles = rng.uniform(-np.pi, np.pi, 50).astype(np.float32)
        gp, gpm = orb.brief_descriptors(T(patches), T(angles))
        rp, rpm = jorb.brief_descriptors(jnp.asarray(patches), jnp.asarray(angles))
        np.testing.assert_array_equal(hamming.words_to_uint32(gp), np.asarray(rp))
        np.testing.assert_array_equal(N(gpm), np.asarray(rpm).astype(np.float32))

    def test_patch_ops(self, rng):
        """Gather exact (clamped starts included); blur and angle are float32
        sums in another order: 1e-3 gray levels, 1e-4 rad."""
        img = random_textured(rng, 80, 90)
        yx = np.array([[40, 45], [19, 19], [0, 0], [79, 89]], np.int32)
        raw = orb._gather_patches(T(img), T(yx), half=orb.GATHER_HALF)
        raw_ref = np.asarray(jorb._gather_patches(jnp.asarray(img), jnp.asarray(yx), half=jorb.GATHER_HALF))
        np.testing.assert_array_equal(N(raw), raw_ref)
        bl = orb.blur_patches(raw, 3.0)
        bl_ref = np.asarray(jorb.blur_patches(jnp.asarray(raw_ref), 3.0))
        np.testing.assert_allclose(N(bl), bl_ref, atol=1e-3)
        np.testing.assert_allclose(N(orb.ic_angle(T(bl_ref))), np.asarray(jorb.ic_angle(jnp.asarray(bl_ref))), atol=1e-4)

    def test_extract_orb(self, rng):
        """Keypoint sets overlap >= 99%, shared angles within 1e-3 rad, and at
        most 0.1% of descriptor bits flip. The flips come from the pyramid's
        last-bit differences (summation order of the resize products and of
        the patch blur), which move a few BRIEF comparisons across zero."""
        img = random_textured(rng, 240, 320)
        cfg = orb.OrbConfig(n_features=500)
        jcfg = jorb.OrbConfig(n_features=500)
        got = orb.extract_orb(T(img), cfg)
        ref = jorb.extract_orb(jnp.asarray(img), jcfg)
        gk = {(int(l), float(x), float(y)): i for i, (l, (x, y), v) in
              enumerate(zip(N(got.level), N(got.xy), N(got.valid))) if v}
        rk = {(int(l), float(x), float(y)): i for i, (l, (x, y), v) in
              enumerate(zip(np.asarray(ref.level), np.asarray(ref.xy), np.asarray(ref.valid))) if v}
        shared = set(gk) & set(rk)
        assert len(shared) >= 0.99 * max(len(gk), len(rk))
        gi = np.array([gk[k] for k in shared])
        ri = np.array([rk[k] for k in shared])
        ga, ra = N(got.angle)[gi], np.asarray(ref.angle)[ri]
        dang = np.abs(np.angle(np.exp(1j * (ga - ra))))
        assert dang.max() <= 1e-3
        gbits = N(hamming.unpack_pm1(got.desc))[gi] > 0
        rbits = np.asarray(jham.unpack_pm1(ref.desc))[ri] > 0
        flips = int(np.sum(gbits != rbits))
        assert flips <= 0.001 * gbits.size, flips


# ---------------------------------------------------------------------------
# matching: integer reductions, exact.
# ---------------------------------------------------------------------------


def _random_features(rng, n, w=640, h=480, dup_every=0):
    """The generator of tests/test_pallas.py, plus optional duplicated
    descriptors (ties of the best distance)."""
    packed = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    if dup_every:
        packed[dup_every::dup_every] = packed[0]
    xy = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], -1).astype(np.float32)
    lvl = rng.integers(0, 8, n).astype(np.int32)
    valid = rng.uniform(size=n) > 0.1
    return packed, xy, lvl, valid


def _both(packed, xy, lvl, valid):
    return ((torch.from_numpy(hamming.words_from_uint32(packed)), T(xy), T(lvl), T(valid)),
            (jham.unpack_pm1(jnp.asarray(packed)), jnp.asarray(xy), jnp.asarray(lvl), jnp.asarray(valid)))


class TestMatching:
    @pytest.mark.parametrize("scalar_radius", [False, True])
    def test_masked_best_two_and_match_projection_exact(self, rng, scalar_radius):
        qn, tn = _random_features(rng, 120, dup_every=7), _random_features(rng, 300, dup_every=5)
        tn[0][:] = qn[0][0]  # every target ties with query 0
        (qt, qj), (tt, tj) = _both(*qn), _both(*tn)
        radius = np.float32(60.0) if scalar_radius else rng.uniform(0, 120, 120).astype(np.float32)
        radius_np = np.asarray(radius)
        if not scalar_radius:
            radius_np[:10] = 0.0  # rows with no candidate
        rj = jnp.asarray(radius_np)
        mask = (jmatch.window_mask(qj[1], tj[1], rj) & jmatch.level_mask(qj[2], tj[2], -1, 1)
                & qj[3][:, None] & tj[3][None, :])
        ref = jmatch.best_two(jham.distance_matrix(qj[0], tj[0]), mask)
        got = matching.masked_best_two(*qt, T(radius_np), *tt)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(N(g), np.asarray(r))
        m = matching.match_projection(qt[0], qt[1], qt[2], qt[3], tt[0], tt[1], tt[2], tt[3], T(radius_np),
                                      max_dist=120, nn_ratio=0.95)
        mr = jmatch.match_projection(qj[0], qj[1], qj[2], qj[3], tj[0], tj[1], tj[2], tj[3], rj,
                                     max_dist=120, nn_ratio=0.95)
        np.testing.assert_array_equal(N(m.ok), np.asarray(mr.ok))
        np.testing.assert_array_equal(N(m.idx)[N(m.ok)], np.asarray(mr.idx)[np.asarray(mr.ok)])
        np.testing.assert_array_equal(N(m.dist), np.asarray(mr.dist))

    def test_batched_equals_rows(self, rng):
        """The batch dimension (the fuse searches) equals per-row calls."""
        qs = [_random_features(rng, 40) for _ in range(3)]
        ts = [_random_features(rng, 70) for _ in range(3)]
        qt = [torch.stack(x) for x in zip(*(_both(*q)[0] for q in qs))]
        tt = [torch.stack(x) for x in zip(*(_both(*t)[0] for t in ts))]
        rad = T(rng.uniform(20, 200, (3, 40)).astype(np.float32))
        got = matching.match_projection(qt[0], qt[1], qt[2], qt[3], tt[0], tt[1], tt[2], tt[3], rad)
        for b in range(3):
            one = matching.match_projection(qt[0][b], qt[1][b], qt[2][b], qt[3][b],
                                            tt[0][b], tt[1][b], tt[2][b], tt[3][b], rad[b])
            for g, o in zip(got, one):
                np.testing.assert_array_equal(N(g[b]), N(o))

    def test_rotation_consistency_and_duplicates_exact(self, rng):
        dang = rng.uniform(-7, 7, 200).astype(np.float32)
        dang[:50] = 0.3  # a dominant bin
        ok = rng.uniform(size=200) > 0.2
        np.testing.assert_array_equal(N(matching.rotation_consistency(T(dang), T(ok))),
                                      np.asarray(jmatch.rotation_consistency(jnp.asarray(dang), jnp.asarray(ok))))
        tie = np.zeros(200, np.float32)  # one bin only: bins 2/3 are empty
        np.testing.assert_array_equal(N(matching.rotation_consistency(T(tie), T(ok))),
                                      np.asarray(jmatch.rotation_consistency(jnp.asarray(tie), jnp.asarray(ok))))
        idx = rng.integers(0, 30, 200).astype(np.int32)
        dist = rng.integers(0, 5, 200).astype(np.int32)
        got = matching.resolve_duplicates(T(idx), T(dist), T(ok), 30)
        ref = jmatch.resolve_duplicates(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(ok), 30)
        np.testing.assert_array_equal(N(got.ok), np.asarray(ref.ok))

    def test_match_nn_exact(self, rng):
        qn, tn = _random_features(rng, 80, dup_every=9), _random_features(rng, 90)
        (qt, qj), (tt, tj) = _both(*qn), _both(*tn)
        mask = rng.uniform(size=(80, 90)) > 0.5
        got = matching.match_nn(hamming.unpack_pm1(qt[0]), hamming.unpack_pm1(tt[0]), T(mask), 120, 0.8)
        ref = jmatch.match_nn(qj[0], tj[0], jnp.asarray(mask), 120, 0.8)
        np.testing.assert_array_equal(N(got.idx), np.asarray(ref.idx))
        np.testing.assert_array_equal(N(got.dist), np.asarray(ref.dist))
        np.testing.assert_array_equal(N(got.ok), np.asarray(ref.ok))


class TestSelectionHelpers:
    def test_stable_topk_matches_lax_top_k(self, rng):
        x = rng.integers(0, 3, (5, 40)).astype(np.int32)
        v, i = stable_topk(T(x), 12)
        rv, ri = jax.lax.top_k(jnp.asarray(x), 12)
        np.testing.assert_array_equal(N(v), np.asarray(rv))
        np.testing.assert_array_equal(N(i), np.asarray(ri))

    def test_scatter_last_matches_xla_duplicate_order(self):
        """Duplicate targets with different values: XLA on the CPU applies the
        updates in order (last wins); the port is deterministic and agrees."""
        idx = np.array([3, 1, 3, 0, 1, 3], np.int32)
        val = np.array([10, 11, 12, 13, 14, 15], np.int32)
        ref = np.asarray(jnp.full(6, -1, jnp.int32).at[jnp.asarray(idx)].set(jnp.asarray(val)))
        np.testing.assert_array_equal(N(scatter_last(torch.full((6,), -1, dtype=torch.int32), T(idx), T(val))), ref)


# ---------------------------------------------------------------------------
# triangulation and motion-only BA
# ---------------------------------------------------------------------------


def test_triangulate_parity(rng):
    """float32 closed form in the same order: rtol 1e-4."""
    K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.asarray(jlie.se3_exp(jnp.asarray([0.2, 0.0, 0.0, 0.0, 0.05, 0.0], jnp.float32)))
    X = (rng.normal(size=(30, 3)) + [0, 0, 5]).astype(np.float32)
    x1 = np.asarray(jproj.project(jnp.asarray(T1), jnp.asarray(X), jnp.asarray(K)))
    x2 = np.asarray(jproj.project(jnp.asarray(T2), jnp.asarray(X), jnp.asarray(K)))
    P1, P2 = jtri.projection_matrix(jnp.asarray(T1), jnp.asarray(K)), jtri.projection_matrix(jnp.asarray(T2), jnp.asarray(K))
    ref = np.asarray(jtri.triangulate(P1, P2, jnp.asarray(x1), jnp.asarray(x2)))
    gP1, gP2 = triangulate.projection_matrix(T(T1), T(K)), triangulate.projection_matrix(T(T2), T(K))
    np.testing.assert_allclose(N(gP1), np.asarray(P1), rtol=1e-6)
    np.testing.assert_allclose(N(triangulate.triangulate(gP1, gP2, T(x1), T(x2))), ref, rtol=1e-4, atol=1e-4)


def _pose_problem(rng, n=300, stereo_frac=0.3, outliers=0.1):
    K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 9, n)], -1).astype(np.float32)
    T_true = np.asarray(jlie.se3_exp(jnp.asarray([0.05, -0.03, 0.02, 0.01, -0.02, 0.015], jnp.float32)))
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([K[0] * pc[:, 0] / pc[:, 2] + K[2], K[1] * pc[:, 1] / pc[:, 2] + K[3]], -1)
    uv += rng.normal(size=uv.shape) * 0.5
    bad = rng.uniform(size=n) < outliers
    uv[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    ur = uv[:, 0] - 40.0 / pc[:, 2]
    stereo = rng.uniform(size=n) < stereo_frac
    target = np.concatenate([uv, np.where(stereo, ur, -1.0)[:, None]], -1).astype(np.float32)
    lvl = rng.integers(0, 4, n)
    inv_s2 = (1.0 / 1.2 ** (2 * lvl)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.05
    return dict(K=K, pts=pts, target=target, inv_s2=inv_s2, stereo=stereo, valid=valid)


def test_pose_optimization_parity(rng):
    """Pose within 1e-4 and an identical inlier mask: the early exit of each
    LM round is read back per iteration, so the iteration counts agree."""
    p = _pose_problem(rng)
    n = p["pts"].shape[0]
    T0 = np.eye(4, dtype=np.float32)
    jobs = jba.Obs(jnp.zeros(n, jnp.int32), jnp.arange(n, dtype=jnp.int32), jnp.asarray(p["target"]),
                   jnp.asarray(p["inv_s2"]), jnp.asarray(p["stereo"]), jnp.asarray(p["valid"]))
    tobs = ba.Obs(torch.zeros(n, dtype=torch.int32), torch.arange(n, dtype=torch.int32), T(p["target"]),
                  T(p["inv_s2"]), T(p["stereo"]), T(p["valid"]))
    Tr, inl_r, n_r = jba.pose_optimization(jnp.asarray(T0), jnp.asarray(p["pts"]), jobs, jnp.asarray(p["K"]), jnp.float32(40.0))
    Tg, inl_g, n_g = ba.pose_optimization(T(T0), T(p["pts"]), tobs, T(p["K"]), 40.0)
    np.testing.assert_allclose(N(Tg), np.asarray(Tr), atol=1e-4)
    np.testing.assert_array_equal(N(inl_g), np.asarray(inl_r))
    assert int(n_g) == int(n_r)
