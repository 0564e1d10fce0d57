"""Stereo frames of the PyTorch port against the JAX package, on the CPU.

A rectified pair rendered at 320x240 (the room of `evaluate.py`'s stereo
dolly, `make_room(default_rng(3))`, at dolly step 4; fx=275, baseline 0.08 m,
bf=22) goes through `ops/stereo.py` and `frontend.build_frame_stereo` of both
packages.

Tolerances: `match_stereo` on the same features exact in `ok` and `ur`,
depth (bf / disparity) within 1e-6 relative; `sad_subpixel_refine` on the same inputs within 1e-4 px (float32 sums
of 121 absolute differences in another order), on every keypoint including
padding slots, unmatched ones (ur = -1) and synthetic ones within 16 px of
the border, where the windows' starts are clamped; `build_frame_stereo`
field by field with the extractor's own tolerances (keypoints within
1e-3 px after undistortion and levels equal on >= 99% of slots, <= 0.1% descriptor bits flipped, see
`test_torch_ops.py::test_extract_orb`) and, on the slots whose keypoint and
stereo match agree, ur and depth within 1e-3.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.models import frontend as jfrontend
from orb_slam2v2_1_tpu.ops import hamming as jham
from orb_slam2v2_1_tpu.ops import orb as jorb
from orb_slam2v2_1_tpu.ops import stereo as jstereo
from orb_slam2v2_1_tpu.utils import synthetic as jsyn

from orb_slam2v2_1_tpu_torch.models import frontend
from orb_slam2v2_1_tpu_torch.ops import orb, stereo
from orb_slam2v2_1_tpu_torch.utils import config, synthetic

torch.set_num_threads(2)

KW = dict(fx=275.0, fy=275.0, cx=160.0, cy=120.0, width=320, height=240, n_features=500, bf=22.0)
STEP = 4


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    """The left and right images at dolly step 4, rendered by the port (the
    renderers agree, `test_torch_slice.py::test_render_parity`)."""
    cfg = config.SlamConfig(**KW)
    left, right, _ = synthetic.stereo_dolly_frames(cfg, [STEP], np.random.default_rng(3), device="cpu")
    return left[0].numpy(), right[0].numpy()


@pytest.fixture(scope="module")
def ref_features(pair):
    ocfg = jorb.OrbConfig(n_features=KW["n_features"])
    return [jorb.extract_orb(jnp.asarray(img), ocfg) for img in pair]


def _match_inputs(fl, fr):
    return [np.asarray(a) for a in (fl.xy, fl.level, fl.desc_pm1.astype(jnp.float32), fl.valid,
                                    fr.xy, fr.level, fr.desc_pm1.astype(jnp.float32), fr.valid)]


def test_match_stereo_exact(ref_features):
    """The same features through both: ok and ur exact, depth within an ulp
    (1e-6 relative); most valid left keypoints find a partner."""
    fl, fr = ref_features
    args = _match_inputs(fl, fr)
    K = np.array([KW["fx"], KW["fy"], KW["cx"], KW["cy"]], np.float32)
    bf = np.float32(KW["bf"])
    ur_r, d_r, ok_r = (np.asarray(a) for a in jstereo.match_stereo(
        *(jnp.asarray(a) for a in args), jnp.float32(bf), jnp.float32(K[0]), jnp.float32(bf) / jnp.float32(K[0])))
    Kt = T(K)
    ur, d, ok = stereo.match_stereo(*(T(a) for a in args), float(bf), Kt[0], float(bf) / Kt[0])
    np.testing.assert_array_equal(ok.numpy(), ok_r)
    np.testing.assert_array_equal(ur.numpy(), ur_r)
    np.testing.assert_allclose(d.numpy(), d_r, rtol=1e-6)  # bf / disparity: XLA divides within an ulp
    assert ok_r.sum() >= 0.5 * np.asarray(fl.valid).sum()


def _refine_inputs(pair, ref_features, rng):
    """The reference's matches plus 40 synthetic keypoints within 16 px of
    the border (half matched at a disparity of 2-12 px, half unmatched)."""
    fl, fr = ref_features
    args = [jnp.asarray(a) for a in _match_inputs(fl, fr)]
    bf = jnp.float32(KW["bf"])
    ur, _, ok = jstereo.match_stereo(*args, bf, jnp.float32(KW["fx"]), bf / jnp.float32(KW["fx"]))
    n = 40
    edge = rng.uniform(0, 16, n)
    xy = np.stack([np.where(np.arange(n) % 2 == 0, edge, rng.uniform(0, 319, n)),
                   np.where(np.arange(n) % 2 == 1, 239 - edge, rng.uniform(0, 239, n))], -1).astype(np.float32)
    xy[::5, 0] = 319 - edge[::5]  # the right border as well
    matched = np.arange(n) < n // 2
    ur_b = np.where(matched, xy[:, 0] - rng.uniform(2, 12, n), -1.0).astype(np.float32)
    xy_all = np.concatenate([np.asarray(fl.xy), xy])
    ur_all = np.concatenate([np.asarray(ur), ur_b])
    ok_all = np.concatenate([np.asarray(ok), matched])
    return xy_all, ur_all, ok_all


def test_sad_subpixel_refine_parity(pair, ref_features, rng):
    """Every slot within 1e-4 px in ur and within 1e-4 relative in depth;
    unmatched slots stay -1 in both; the refinement moves the matched ones."""
    left, right = pair
    xy, ur, ok = _refine_inputs(pair, ref_features, rng)
    bf = np.float32(KW["bf"])
    ur_r, d_r = (np.asarray(a) for a in jstereo.sad_subpixel_refine(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(xy), jnp.asarray(ur), jnp.asarray(ok), jnp.float32(bf)))
    ur_t, d_t = stereo.sad_subpixel_refine(T(left), T(right), T(xy), T(ur), T(ok), float(bf))
    np.testing.assert_allclose(ur_t.numpy(), ur_r, atol=1e-4)
    np.testing.assert_allclose(d_t.numpy(), d_r, rtol=1e-4)
    assert np.all(ur_r[~ok] == -1) and np.all(ur_t.numpy()[~ok] == -1)
    assert np.abs(ur_r[ok] - ur[ok]).max() > 0.1


def test_sad_windows_follow_dynamic_slice_starts():
    """Near the border the clamped starts decide which pixels a window
    sees: a keypoint 2 px from the left edge against one at the first
    unclamped position must give different windows, and both packages agree
    on both."""
    rng = np.random.default_rng(5)
    left = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    right = np.roll(left, -3, axis=1)
    xy = np.array([[2.0, 30.0], [40.0, 2.0], [77.6, 57.4], [40.0, 30.0]], np.float32)
    ur = xy[:, 0] - 3.0
    ok = np.ones(4, bool)
    ref = np.asarray(jstereo.sad_subpixel_refine(jnp.asarray(left), jnp.asarray(right), jnp.asarray(xy),
                                                 jnp.asarray(ur), jnp.asarray(ok), jnp.float32(10.0))[0])
    got = stereo.sad_subpixel_refine(T(left), T(right), T(xy), T(ur), T(ok), 10.0)[0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert abs(got[3] - (40.0 - 3.0)) < 0.05  # an interior keypoint finds the true shift


def test_build_frame_stereo_parity(pair):
    """Field by field against the reference's `build_frame_stereo`."""
    left, right = pair
    cfg = config.SlamConfig(**KW)
    ocfg = orb.OrbConfig(n_features=cfg.n_features)
    K, dist = np.asarray(cfg.K, np.float32), np.asarray(cfg.dist, np.float32)
    ref = jfrontend.build_frame_stereo(jnp.asarray(left), jnp.asarray(right), jnp.asarray(K), jnp.asarray(dist),
                                       jnp.float32(cfg.bf), jnp.int32(3), jorb.OrbConfig(n_features=cfg.n_features),
                                       cfg.width, cfg.height)
    got = frontend.build_frame_stereo(T(left), T(right), T(K), T(dist), float(np.float32(cfg.bf)), 3, ocfg)
    r = {name: np.asarray(v) for name, v in zip(ref._fields, ref)}
    g = {name: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for name, v in zip(got._fields, got)}
    same = (np.abs(g["xy"] - r["xy"]).max(-1) <= 1e-3) & (g["level"] == r["level"]) & (g["kp_valid"] == r["kp_valid"])
    assert same.mean() >= 0.99
    both = same & r["kp_valid"]
    np.testing.assert_array_equal(g["pose"], r["pose"])
    np.testing.assert_array_equal(g["mp"], r["mp"])
    assert int(g["frame_id"]) == int(r["frame_id"]) == 3
    dang = np.abs(np.angle(np.exp(1j * (g["angle"][both] - r["angle"][both]))))
    assert dang.max() <= 1e-3
    gbits = np.asarray(g["desc_pm1"])[both] > 0
    rbits = np.asarray(r["desc_pm1"].astype(np.float32))[both] > 0
    assert np.sum(gbits != rbits) <= 0.001 * gbits.size
    np.testing.assert_array_equal(
        np.asarray(jham.unpack_pm1(jnp.asarray(r["desc"]))).astype(np.float32)[both] > 0, rbits)
    stereo_same = both & ((g["ur"] >= 0) == (r["ur"] >= 0))
    assert stereo_same.sum() >= 0.98 * both.sum()
    m = stereo_same & (r["ur"] >= 0)
    assert m.sum() >= 0.5 * both.sum()
    np.testing.assert_allclose(g["ur"][m], r["ur"][m], atol=1e-3)
    np.testing.assert_allclose(g["depth"][m], r["depth"][m], rtol=1e-3)
    assert np.all(g["depth"][~(g["ur"] >= 0)] == -1)


def test_build_frame_stereo_depth_is_right(pair):
    """The port's stereo disparities agree with the renderer's depth map:
    median error under 0.5 px (at this baseline a 7.8 m wall is 2.8 px of
    disparity, so depth itself is only good to ~10%, in the reference too)."""
    left, right = pair
    cfg = config.SlamConfig(**KW)
    frame = frontend.build_frame_stereo(T(left), T(right), torch.tensor(cfg.K), torch.tensor(cfg.dist),
                                        float(np.float32(cfg.bf)), 0, orb.OrbConfig(n_features=cfg.n_features))
    scene = synthetic.make_room(np.random.default_rng(3), device="cpu")
    _, depth = synthetic.render(scene, T(synthetic.dolly_pose(STEP)), torch.tensor(cfg.K), cfg.width, cfg.height)
    m = frame.depth > 0
    xi, yi = frame.xy[m, 0].round().long(), frame.xy[m, 1].round().long()
    truth = depth[yi.clamp(0, cfg.height - 1), xi.clamp(0, cfg.width - 1)]
    err = (cfg.bf / frame.depth[m] - cfg.bf / truth).abs().numpy()
    assert m.sum() > 100 and np.median(err) < 0.5, np.median(err)


def test_stereo_dolly_frames_match_the_reference_renderer():
    """`synthetic.stereo_dolly_frames` is `evaluate.py`'s `synth_stereo` on
    the dolly poses: the left and right images of step 2 within 1e-2 gray
    levels of the reference's renderer on 99% of pixels."""
    cfg = config.SlamConfig(**dict(KW, width=96, height=72, fx=80.0, fy=80.0, cx=48.0, cy=36.0, bf=6.4))
    left, right, _ = synthetic.stereo_dolly_frames(cfg, [2], np.random.default_rng(3), device="cpu")
    room = jsyn.make_room(np.random.default_rng(3))
    Tl = synthetic.dolly_pose(2)
    Tr = Tl.copy()
    Tr[0, 3] -= cfg.bf / cfg.fx
    for got, Tcw in ((left[0], Tl), (right[0], Tr)):
        ref, _ = jsyn.render(room, jnp.asarray(Tcw), jnp.asarray(cfg.K, jnp.float32), cfg.width, cfg.height)
        diff = np.abs(got.numpy() - np.asarray(ref))
        assert np.mean(diff <= 1e-2) >= 0.99
