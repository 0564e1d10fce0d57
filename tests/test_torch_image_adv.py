"""Image filters and the adversarial scenes of `evaluate.py` on both packages (CPU).

- `ops/image.py`: `gaussian_blur` within 1e-4 gray levels, `rgb_to_gray`
  exact.
- `utils/synthetic.py`: `make_adversarial` (free and 35-degree tilt) with
  plane arrays and textures exact and the generator in the same state after;
  `exposure_schedule` exact; `degrade_frame` exact on the same image and
  generator, with and without motion blur; `flow_blur` equal to
  evaluate.py's `_flow_blur`.
- `adversarial_frames` against evaluate.py's `synth_rgbd` / `synth_mono` /
  `synth_stereo` with the same renders (evaluate.py's render swapped for the
  port's): every frame exact and the generator in the same state after, so
  the draws come in evaluate.py's order.
- `SlamSystem(sensor=RGBD)` in sync mode on the first 12 frames of the
  adversarial RGB-D leg (`make_adversarial(default_rng(21))` along
  `desk_trajectory(150, extent=0.55)`) at 320x240 (fx=fy=275, 700
  features): the same `None` pattern, poses within 2 mm / 0.05 deg, equal
  keyframes.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.models import system as jsystem
from orb_slam2v2_1_tpu.ops import image as jimage
from orb_slam2v2_1_tpu.utils import config as jconfig
from orb_slam2v2_1_tpu.utils import synthetic as jsyn

from orb_slam2v2_1_tpu_torch.models import system
from orb_slam2v2_1_tpu_torch.ops import image
from orb_slam2v2_1_tpu_torch.utils import config, synthetic

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(fx=275.0, fy=275.0, cx=160.0, cy=120.0, width=320, height=240, n_features=700,
          max_keyframes=16, max_map_points=4096, fps=10.0, bf=44.0, th_depth=40.0)
N_FRAMES = 12


@pytest.fixture(scope="module")
def evaluate():
    spec = importlib.util.spec_from_file_location("evaluate_ref", os.path.join(ROOT, "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("size, sigma", [(7, 2.0), (5, 1.2)])
def test_gaussian_blur_parity(rng, size, sigma):
    img = (rng.random((48, 64)) * 255).astype(np.float32)
    ref = np.asarray(jimage.gaussian_blur(jnp.asarray(img), size=size, sigma=sigma))
    got = image.gaussian_blur(torch.from_numpy(img), size=size, sigma=sigma).numpy()
    assert got.shape == ref.shape == img.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgb_to_gray_exact(rng, dtype):
    img = (rng.random((20, 30, 3)) * 255).astype(dtype)
    ref = np.asarray(jimage.rgb_to_gray(jnp.asarray(img)))
    got = image.rgb_to_gray(torch.from_numpy(img)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("tilt", [None, 35.0])
def test_make_adversarial_exact(tilt):
    r_ref, r_got = np.random.default_rng(22), np.random.default_rng(22)
    ref = jsyn.make_adversarial(r_ref, tex_size=64, max_tilt_deg=tilt)
    got = synthetic.make_adversarial(r_got, tex_size=64, max_tilt_deg=tilt, device="cpu")
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.origin.shape == (30, 3)
    assert r_got.bit_generator.state == r_ref.bit_generator.state


@pytest.mark.parametrize("n, lo, hi", [(150, 0.55, 1.7), (100, 0.7, 1.45), (12, 0.55, 1.7)])
def test_exposure_schedule_exact(n, lo, hi):
    r_ref, r_got = np.random.default_rng(5), np.random.default_rng(5)
    ref = jsyn.exposure_schedule(n, r_ref, lo=lo, hi=hi)
    got = synthetic.exposure_schedule(n, r_got, lo=lo, hi=hi)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert r_got.bit_generator.state == r_ref.bit_generator.state


@pytest.mark.parametrize("blur_dir, blur_len", [(None, 0), ((0.6, 0.8), 7), ((-0.28, 0.96), 4), ((1.0, 0.0), 9)])
def test_degrade_frame_exact(rng, blur_dir, blur_len):
    img = (rng.random((60, 80)) * 255).astype(np.float32)
    d = None if blur_dir is None else np.asarray(blur_dir, np.float32)
    r_ref, r_got = np.random.default_rng(3), np.random.default_rng(3)
    ref = np.asarray(jsyn.degrade_frame(jnp.asarray(img), r_ref, 1.37, d, blur_len, 3.0))
    got = synthetic.degrade_frame(torch.from_numpy(img), r_got, 1.37, d, blur_len, 3.0).numpy()
    np.testing.assert_array_equal(got, ref)
    assert r_got.bit_generator.state == r_ref.bit_generator.state


def _norm(poses):
    return [p @ np.linalg.inv(poses[0]) for p in poses]


def test_flow_blur_matches_evaluate(evaluate):
    cfg = config.SlamConfig(**KW)
    poses = _norm(synthetic.desk_trajectory(150))
    for i in (0, 1, 40, 75, 149):
        d_ref, l_ref = evaluate._flow_blur(poses, i, cfg)
        d_got, l_got = synthetic.flow_blur(poses, i, cfg)
        assert l_got == l_ref
        assert (d_got is None) == (d_ref is None)
        if d_ref is not None:
            np.testing.assert_array_equal(d_got, d_ref)


@pytest.mark.parametrize("mode", ["rgbd", "mono", "stereo"])
def test_adversarial_frames_match_evaluate(evaluate, monkeypatch, mode):
    """The port's renders stand in for the reference's in evaluate.py (the
    renderers agree to 1e-2 gray levels, `test_torch_desk.py`), so the
    degraded frames compare exactly."""
    cfg = dataclasses.replace(config.SlamConfig(**KW), width=96, height=72, fx=80.0, fy=80.0, cx=48.0, cy=36.0)
    if mode == "stereo":
        cfg = dataclasses.replace(cfg, bf=22.0)
    scene = synthetic.make_adversarial(np.random.default_rng(21), tex_size=64, device="cpu")
    jscene = jsyn.PlaneScene(*(jnp.asarray(a.numpy()) for a in scene))

    def port_render(_scene, Tcw, K, width, height):
        img, depth = synthetic.render(scene, torch.from_numpy(np.array(Tcw)), torch.from_numpy(np.array(K)),
                                      width, height)
        return jnp.asarray(img.numpy()), jnp.asarray(depth.numpy())

    monkeypatch.setattr(jsyn, "render", port_render)
    poses = _norm(synthetic.desk_trajectory(20, extent=0.55))
    r_ref, r_got = np.random.default_rng(43), np.random.default_rng(43)
    synth = {"rgbd": evaluate.synth_rgbd, "mono": evaluate.synth_mono, "stereo": evaluate.synth_stereo}[mode]
    ref = synth(cfg, jscene, poses, r_ref, adversarial=True)
    imgs, second = synthetic.adversarial_frames(cfg, scene, poses, r_got, mode)
    assert r_got.bit_generator.state == r_ref.bit_generator.state
    assert imgs.shape == (20, 72, 96)
    for i, fr in enumerate(ref):
        np.testing.assert_array_equal(imgs[i].numpy(), np.asarray(fr[0]))
        if mode == "mono":
            assert second is None and fr[1] is None
        else:
            np.testing.assert_array_equal(second[i].numpy(), np.asarray(fr[1]))


def _centers(poses):
    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in np.asarray(poses, np.float64)])


def test_adversarial_rgbd_slam_parity():
    cfg = config.SlamConfig(**KW)
    scene = synthetic.make_adversarial(np.random.default_rng(21), device="cpu")
    poses = _norm(synthetic.desk_trajectory(150, extent=0.55))
    imgs, deps = synthetic.adversarial_frames(cfg, scene, poses, np.random.default_rng(21), "rgbd")
    imgs, deps = imgs[:N_FRAMES].numpy(), deps[:N_FRAMES].numpy()
    outs = []
    for slam in (jsystem.SlamSystem(config=jconfig.SlamConfig(**KW), sensor=jsystem.Sensor.RGBD),
                 system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, device="cpu")):
        outs.append((slam, [slam.track_rgbd(imgs[i], deps[i], i * 0.1) for i in range(N_FRAMES)]))
    (jslam, jout), (tslam, tout) = outs
    assert [o is None for o in tout] == [o is None for o in jout]
    both = [i for i, o in enumerate(jout) if o is not None]
    assert len(both) >= N_FRAMES - 2
    t = np.asarray([tout[i] for i in both], np.float64)
    j = np.asarray([jout[i] for i in both], np.float64)
    assert np.linalg.norm(_centers(t) - _centers(j), axis=1).max() <= 2e-3
    R = np.einsum("fji,fjk->fik", t[:, :3, :3], j[:, :3, :3])
    assert np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1))).max() <= 0.05
    assert tslam.n_kf_host == jslam.n_kf_host >= 2
