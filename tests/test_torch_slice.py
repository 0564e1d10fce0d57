"""The whole RGB-D slice, `track_sequence_rgbd`, on both packages (CPU).

Frames 0-15 of the benchmark's 321-frame orbit, rendered at 320x240
(fx=fy=275, cx=160, cy=120, bf=44, 500 features, 16 keyframes, 4096 map
points: the top pyramid level is then 67x89 px, larger than the 39-px
descriptor patch), go through both packages. The run includes the first
keyframe insertion after the initial one (frame 10).

Tolerances: identical `ok` vectors; per-frame pose difference <= 2 mm in
camera center and <= 0.05 deg in rotation; equal keyframe count; live
map-point count within 2%. The packages differ only in float32 summation
order (pyramid resize, patch blur, BA reductions), which flips a handful of
descriptor bits and moves poses by measured <= 0.22 mm and map points by
<= 1 point over these frames.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.models import keyframe_database as jkdb
from orb_slam2v2_1_tpu.models import loop_closing as jlc
from orb_slam2v2_1_tpu.models import offline as joff
from orb_slam2v2_1_tpu.ops import vocab as jvocab
from orb_slam2v2_1_tpu.utils import config as jconfig
from orb_slam2v2_1_tpu.utils import synthetic as jsyn
from orb_slam2v2_1_tpu.ops import lie as jlie

from orb_slam2v2_1_tpu_torch import sync
from orb_slam2v2_1_tpu_torch.models import keyframe_database as kdb
from orb_slam2v2_1_tpu_torch.models import loop_closing as lc
from orb_slam2v2_1_tpu_torch.models import map_state, offline
from orb_slam2v2_1_tpu_torch.ops import vocab
from orb_slam2v2_1_tpu_torch.utils import config, synthetic

torch.set_num_threads(2)

KW = dict(fx=275.0, fy=275.0, cx=160.0, cy=120.0, width=320, height=240, n_features=500,
          max_keyframes=16, max_map_points=4096, fps=10.0, bf=44.0, th_depth=100.0)
N_FRAMES = 16
VOCAB_NPZ = jvocab.__file__.replace("ops/vocab.py", "data/vocab.npz")


@pytest.fixture(scope="module")
def frames():
    imgs, deps, gt = synthetic.orbit_frames(config.SlamConfig(**KW), N_FRAMES, device="cpu", total=321)
    return imgs.numpy(), deps.numpy(), gt


@pytest.fixture(scope="module")
def runs(frames):
    imgs, deps, _ = frames
    ref = joff.track_sequence_rgbd(imgs, deps, jconfig.SlamConfig(**KW))
    sync.reset()
    got = offline.track_sequence_rgbd(imgs, deps, config.SlamConfig(**KW), device="cpu")
    return ref, got, sync.COUNT["syncs"]


def _centers(poses):
    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])


def test_slice_parity(runs):
    (jposes, jok, jstate), (poses, ok, state), _ = runs
    assert bool(np.all(jok)), "the reference must track every frame at this size"
    np.testing.assert_array_equal(ok, jok)
    dc = np.linalg.norm(_centers(poses) - _centers(jposes), axis=1)
    assert dc.max() <= 2e-3, dc
    R = np.einsum("fji,fjk->fik", poses[:, :3, :3], jposes[:, :3, :3])
    ang = np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert ang.max() <= 0.05, ang
    n_kf, j_kf = int(state.kf_valid.sum()), int(np.asarray(jstate.kf_valid).sum())
    assert n_kf == j_kf and n_kf >= 2
    n_mp, j_mp = int(state.mp_valid.sum()), int(np.asarray(jstate.mp_valid).sum())
    assert abs(n_mp - j_mp) <= 0.02 * j_mp, (n_mp, j_mp)


def test_syncs_bounded(runs):
    """The host reads per frame: <= 2 for the tracking fallbacks, one per LM
    iteration (<= 4 rounds x 10 per pose optimization, <= 3 of them), one
    for the keyframe decision, and <= 10 per local-BA pass."""
    _, _, syncs = runs
    assert 0 < syncs <= N_FRAMES * (2 + 3 * 40 + 1) + 20


def test_chunked_equals_whole(frames, runs):
    """Staging frames in chunks changes nothing."""
    imgs, deps, _ = frames
    _, (poses, ok, state), _ = runs
    p2, ok2, s2 = offline.track_sequence_rgbd(imgs[:12], deps[:12], config.SlamConfig(**KW), chunk=5, device="cpu")
    np.testing.assert_array_equal(ok2, ok[:12])
    np.testing.assert_array_equal(p2, poses[:12])


@pytest.fixture(scope="module")
def loop_runs(frames):
    """The 16 frames through both packages with a loop closer (the shared
    vocabulary, a 16 x 500 x 10000 database, detached global BA) in chunks of
    5 frames."""
    imgs, deps, _ = frames
    npz = np.load(VOCAB_NPZ)
    jcl = jlc.LoopCloser(jvocab.load_vocabulary(npz), jkdb.empty_database(16, 500, 10000), True,
                         jnp.asarray(jconfig.SlamConfig(**KW).K), jnp.float32(KW["bf"]))
    tcl = lc.LoopCloser(vocab.load_vocabulary(npz, device="cpu"), kdb.empty_database(16, 500, 10000, device="cpu"),
                        True, torch.tensor(config.SlamConfig(**KW).K), KW["bf"])
    jcl.enable_detached_gba()
    tcl.enable_detached_gba()
    ref = joff.track_sequence_rgbd(imgs, deps, jconfig.SlamConfig(**KW), loop_closer=jcl, chunk=5)
    got = offline.track_sequence_rgbd(imgs, deps, config.SlamConfig(**KW), loop_closer=tcl, chunk=5, device="cpu")
    return ref, got, jcl, tcl


def test_slice_with_loop_closer(loop_runs, runs):
    """The slice with a loop closer: identical `ok`, poses within 2 mm /
    0.05 deg of the reference's run with its loop closer, equal keyframe and
    insertion counts, no closure
    on 16 frames and no global BA left running. The closer's vocabulary
    prunes the reference-keyframe and triangulation searches, so the map
    differs from the run without one."""
    (jposes, jok, jstate), (poses, ok, state), jcl, tcl = loop_runs
    np.testing.assert_array_equal(ok, jok)
    assert bool(np.all(ok))
    dc = np.linalg.norm(_centers(poses) - _centers(jposes), axis=1)
    assert dc.max() <= 2e-3, dc
    R = np.einsum("fji,fjk->fik", poses[:, :3, :3], jposes[:, :3, :3])
    ang = np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert ang.max() <= 0.05, ang
    assert tcl.kf_counter == jcl.kf_counter == int(state.kf_valid.sum()) >= 2
    assert int(state.kf_valid.sum()) == int(np.asarray(jstate.kf_valid).sum())
    assert tcl.n_loops_closed == jcl.n_loops_closed == 0 and tcl.n_gba_merged == 0
    assert not tcl.gba_runner.running
    _, (_, _, plain_state), _ = runs
    assert int(state.mp_valid.sum()) != int(plain_state.mp_valid.sum())


def test_loop_closer_database_parity(loop_runs):
    """The BoW database after the run: `valid` equal, the word rows of the
    registered keyframes exact (their descriptors are bit-equal in the two
    packages on these frames), vectors within 1e-6."""
    (_, _, jstate), (_, _, state), jcl, tcl = loop_runs
    got = kdb.database_to_numpy(tcl.db)
    valid = np.asarray(jcl.db.valid)
    np.testing.assert_array_equal(got["valid"], valid)
    assert valid.sum() >= 2
    np.testing.assert_array_equal(map_state.to_numpy(state)["kf_desc"][valid], np.asarray(jstate.kf_desc)[valid])
    np.testing.assert_array_equal(got["words"][valid], np.asarray(jcl.db.words)[valid])
    np.testing.assert_allclose(got["vectors"][valid], np.asarray(jcl.db.vectors)[valid], atol=1e-6)


def test_load_settings_parity(tmp_path):
    """The settings parser and the ready-made configs equal the reference's,
    field for field (a pure-Python copy: exact)."""
    path = tmp_path / "settings.yaml"
    path.write_text("%YAML:1.0\nCamera.fx: 535.4  # focal\nCamera.fy: 539.2\nCamera.width: 640\n"
                    "ThDepth: 40.0\nORBextractor.nFeatures: 1000\nORBextractor.scaleFactor: 1.2\n"
                    "Viewer.KeyFrameSize: 0.05\n")
    for got, ref in ((config.load_settings(path), jconfig.load_settings(path)),
                     (config.TUM_FR1, jconfig.TUM_FR1), (config.KITTI_00, jconfig.KITTI_00),
                     (config.EUROC, jconfig.EUROC)):
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.K == ref.K and got.dist == ref.dist


def test_render_parity():
    """The port's renderer against the reference's on the orbit's first
    pose: images within 1e-2 gray levels away from plane edges (ray/plane
    float32 arithmetic in another order moves texture coordinates by ulps),
    depths within 1e-4 m."""
    cfg = dataclasses.replace(config.SlamConfig(**KW), width=96, height=72, fx=80.0, fy=80.0, cx=48.0, cy=36.0)
    rng = np.random.default_rng(11)
    room = jsyn.make_room(rng, tex_size=64)
    scene_j = jsyn.PlaneScene(room.origin[:6], room.ux[:6], room.vy[:6], room.tex[:6])
    scene_t = synthetic.PlaneScene(*(torch.from_numpy(np.asarray(a)) for a in scene_j))
    Tcw = synthetic.orbit_pose(7, 321)
    ji, jd = jsyn.render(scene_j, jnp.asarray(Tcw), jnp.asarray(cfg.K, jnp.float32), cfg.width, cfg.height)
    ti, td = synthetic.render(scene_t, torch.from_numpy(Tcw), torch.tensor(cfg.K), cfg.width, cfg.height)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    diff = np.abs(ti.numpy() - np.asarray(ji))
    assert np.mean(diff <= 1e-2) >= 0.99 and diff.max() < 255
    # The ground-truth pose is the reference's orbit pose.
    th = 2.0 * 2 * np.pi * 7 / 321
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.0, th, 0.0], jnp.float32)))
    np.testing.assert_allclose(np.linalg.inv(Tcw)[:3, :3], R, atol=1e-6)
