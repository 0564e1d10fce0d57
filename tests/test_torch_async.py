"""`SlamSystem(async_mapping=True)` on the desk and the split mapping
programs, on both packages (CPU), under the settled schedule of
`torch_async_helpers.py`.

- `SlamSystem(async_mapping=True, sensor=RGBD)` on 16 frames of the desk
  sweep at 320x240 and fps=3 (a keyframe at least every 3 frames: 6
  keyframes, 5 mapping rounds): the same `None` pattern, poses within 2 mm /
  0.05 deg, equal keyframe counts and `stats()` counters.
- `frontend.append_keyframe_only` and `mapping_pipeline` at `allow_ba` True
  and False, on the reference's settled desk map and its last frame: integer
  and boolean map fields exact; floats within 1e-4, where the local BA ran
  poses 2e-3 and points 2e-2 (the tolerances `test_torch_mapping.py` holds
  the insertion stages and the local BA to).
- `reset` stops the workers and starts new ones (`tests/test_slam_e2e.py:140-152`).
- A keyframe tracked on a snapshot is re-anchored on its reference keyframe
  when the live map moved meanwhile (a loop correction).
- On the card (`cuda` marker): 30 desk frames async and settled on the card
  against the same run on the CPU, poses within 2 mm.
The stereo and mono parity runs are in `test_torch_async_sensors.py`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_async_helpers import assert_runs_agree, centers, instrument, pair, run_settled, settle

from orb_slam2v2_1_tpu.models import frontend as jfrontend
from orb_slam2v2_1_tpu.models.map_state import MapState as JMapState
from orb_slam2v2_1_tpu.utils import config as jconfig

from orb_slam2v2_1_tpu_torch.models import frontend, map_state, system, tracking
from orb_slam2v2_1_tpu_torch.ops import vocab
from orb_slam2v2_1_tpu_torch.utils import config, synthetic

torch.set_num_threads(2)

BASE = dict(fx=275.0, fy=275.0, cx=160.0, cy=120.0, width=320, height=240, n_features=700,
            max_keyframes=16, max_map_points=4096, fps=10.0, bf=44.0, th_depth=100.0)
DESK_KW = dict(BASE, fps=3.0, th_depth=40.0)
N_DESK = 16


@pytest.fixture(scope="module")
def desk_runs():
    imgs, deps, _ = synthetic.desk_frames(config.SlamConfig(**DESK_KW), synthetic.desk_trajectory(150)[:N_DESK],
                                          device="cpu")
    frames = list(zip(imgs.numpy(), deps.numpy()))
    jslam, tslam = pair("RGBD", DESK_KW)
    try:
        jout = run_settled(jslam, frames, jslam.track_rgbd)
        tout = run_settled(tslam, frames, tslam.track_rgbd)
        yield jslam, tslam, jout, tout
    finally:
        jslam.shutdown()
        tslam.shutdown()


def test_desk_rgbd_async_parity(desk_runs):
    jslam, tslam, jout, tout = desk_runs
    assert all(o is not None for o in jout)
    assert_runs_agree(jslam, tslam, jout, tout, min_kf=5)
    assert tslam.stats()["map_ms_p50"] is not None and tslam.stats()["loop_ms_p50"] is not None


@pytest.fixture(scope="module")
def mapping_inputs(desk_runs):
    """The reference's settled async desk map, its last frame, and both
    packages' append of that frame as a new keyframe."""
    jslam = desk_runs[0]
    jstate, _ = jslam._box.read()
    jframe = jslam.last_frame
    cfg = jconfig.SlamConfig(**DESK_KW)
    K = jnp.asarray(cfg.K, jnp.float32)
    dl = np.float32(cfg.bf * cfg.th_depth / cfg.fx)
    ref_state, ref_kf = jfrontend.append_keyframe_only(jstate, jframe, K, jnp.float32(cfg.bf), jnp.float32(dl))
    tstate = map_state.from_numpy({n: np.asarray(v) for n, v in zip(JMapState._fields, jstate)}, device="cpu")
    tframe = tracking.frame_from_numpy({n: np.asarray(v) for n, v in zip(jframe._fields, jframe)}, device="cpu")
    got_state, got_kf = frontend.append_keyframe_only(tstate, tframe, torch.tensor(cfg.K), float(cfg.bf), float(dl))
    return jslam, cfg, (ref_state, int(ref_kf)), (got_state, int(got_kf)), tstate


def assert_state_close(ref, got, atol=1e-4, rtol=1e-4, loose=None):
    """Integer and boolean fields exact; floats within atol/rtol, the fields
    of `loose` (field -> atol) within theirs."""
    ref = {n: np.asarray(v) for n, v in zip(JMapState._fields, ref)}
    got = map_state.to_numpy(got)
    for k, a in ref.items():
        b = got[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, atol=(loose or {}).get(k, atol), rtol=rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_append_keyframe_only_parity(mapping_inputs):
    _, _, (ref_state, ref_kf), (got_state, got_kf), tstate = mapping_inputs
    assert got_kf == ref_kf
    assert_state_close(ref_state, got_state)
    # Out of place: the snapshot it was given is unchanged.
    assert not bool(tstate.kf_valid[got_kf]) and bool(got_state.kf_valid[got_kf])


@pytest.mark.parametrize("allow_ba", [True, False])
def test_mapping_pipeline_parity(mapping_inputs, allow_ba):
    jslam, cfg, (ref_state, kf), _, _ = mapping_inputs
    K = jnp.asarray(cfg.K, jnp.float32)
    ref = jfrontend.mapping_pipeline(ref_state, jnp.int32(kf), K, jnp.float32(cfg.bf), jax.random.key(kf),
                                     allow_ba, voc=jslam.vocab)
    voc = vocab.load_vocabulary(np.load(system.VOCAB_NPZ), device="cpu")
    start = map_state.from_numpy({n: np.asarray(v) for n, v in zip(JMapState._fields, ref_state)}, device="cpu")
    got = frontend.mapping_pipeline(start, torch.tensor(kf), torch.tensor(cfg.K), float(cfg.bf), allow_ba, voc=voc)
    assert int(got[1]) == int(ref[1]) and int(got[2]) == int(ref[2])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=1e-4)
    assert_state_close(ref[0], got[0], loose={"kf_pose": 2e-3, "mp_pos": 2e-2} if allow_ba else None)


def test_reset_restarts_workers():
    """A reset stops the workers without draining and starts new ones on the
    empty map; tracking then initializes again (tests/test_slam_e2e.py:140-152)."""
    imgs, deps, _ = synthetic.desk_frames(config.SlamConfig(**DESK_KW), synthetic.desk_trajectory(150)[:6],
                                          device="cpu")
    slam = instrument(system.SlamSystem(config=config.SlamConfig(**DESK_KW), sensor=system.Sensor.RGBD,
                                        device="cpu", async_mapping=True))
    try:
        for i in range(6):
            slam.track_rgbd(imgs[i], deps[i], i * 0.1)
        old = slam._mapper
        slam.reset()
        assert slam.state == system.TrackState.NO_IMAGES_YET and slam.n_resets == 1
        assert old._map_worker.done() and old._loop_worker.done()
        assert slam._mapper is not old and slam._box.version == 0 and slam._mapper.n_submitted == 0
        assert not bool(slam._box.read()[0].kf_valid.any())
        for i in range(6):
            slam.track_rgbd(imgs[i], deps[i], i * 0.1)
    finally:
        slam.shutdown()
    assert slam.state == system.TrackState.OK and slam.n_kf_host >= 2
    assert slam._mapper is None and len(slam.trajectory.entries) == 6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_async_desk_on_card(cuda_device):
    """30 frames of the desk sweep, async and settled, on the card (both
    kernels, the workers launching kernel 2) against the same run on the
    CPU: the same `None` pattern and keyframes, poses within 2 mm. The desk,
    not the orbit: the orbit turns in place, and at 320x240 the card's and
    the CPU's last-bit differences grow to 8.8 mm over 30 frames there (the
    reference drifts 0.198 m from itself under 0.001 gray levels of noise,
    `torch_reference_orbit.py --sensitivity`)."""
    from orb_slam2v2_1_tpu_torch import kernels

    cfg = config.SlamConfig(**DESK_KW)
    imgs, deps, _ = synthetic.desk_frames(cfg, synthetic.desk_trajectory(150)[:30], device="cpu")
    outs = {}
    for dev in ("cpu", cuda_device):
        slam = instrument(system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, device=dev, async_mapping=True))
        kernels.reset_launch_counts()
        try:
            outs[str(dev)] = (run_settled(slam, list(zip(imgs.to(dev), deps.to(dev))), slam.track_rgbd),
                              slam.n_kf_host)
        finally:
            slam.shutdown()
    (cpu, n_cpu), (gpu, n_gpu) = outs["cpu"], outs[str(cuda_device)]
    assert [o is None for o in gpu] == [o is None for o in cpu] and n_gpu == n_cpu >= 5
    dc = np.linalg.norm(centers([o for o in gpu if o is not None]) - centers([o for o in cpu if o is not None]), axis=1)
    assert dc.max() <= 2e-3, dc
    assert kernels.LAUNCHES_BY_ROLE["masked_best_two"].get("mapping", 0) > 0


def test_keyframe_drops_associations_to_killed_points():
    """A keyframe appended from a frame tracked on a snapshot keeps only the
    associations whose slot still holds the same live point. Here 60 of the
    frame's points are killed in the live map meanwhile (what a loop fusion
    does to the current side), so their slots are free and the keyframe's own
    depth points take them: the new keyframe's row then names every point
    once, only live points, each the snapshot's point or one it created. The
    reference keeps the 60 stale ids, and its row names its new depth points
    twice (on the card, 3-7 keyframes of a run of chip_smoke.py's phase 11
    took 24-83 such ids in all)."""
    cfg = config.SlamConfig(**DESK_KW)
    imgs, deps, _ = synthetic.desk_frames(cfg, synthetic.desk_trajectory(150)[:7], device="cpu")
    slam = instrument(system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, device="cpu", async_mapping=True))
    try:
        run_settled(slam, list(zip(imgs[:6], deps[:6])), slam.track_rgbd)
        snap, _ = slam._box.read()
        res = frontend.process_frame_impl(
            snap, imgs[6], deps[6], slam.last_frame, slam._velocity_dev, slam._have_velocity, slam.ref_kf,
            slam._K, slam._dist, slam._bf, slam._depth_limit, 6, slam._orb_cfg, cfg.width, cfg.height, slam.vocab)
        ids = torch.unique(res.frame.mp[res.frame.mp >= 0])
        assert ids.numel() > 100
        killed = ids[torch.randperm(ids.numel(), generator=torch.Generator().manual_seed(0))[:60]].long()

        def kill(s):
            dead = torch.zeros(s.max_mp, dtype=torch.bool)
            dead[killed] = True
            rows = torch.where(dead[torch.clamp(s.kf_mp, min=0).long()] & (s.kf_mp >= 0), -1, s.kf_mp)
            return s._replace(mp_valid=s.mp_valid & ~dead, kf_mp=rows)

        slam._box.mutate(kill)
        slam._insert_keyframe_async(res, slam.ref_kf)
        kf = slam.ref_kf
        row = slam.map.kf_mp[kf]
        named = row[row >= 0]
        assert torch.unique(named).numel() == named.numel()  # no point named twice
        assert bool(slam.map.mp_valid[named.long()].all())
        reused = torch.isin(killed, named)
        assert bool(reused.any())  # the freed slots went to the keyframe's depth points
        for slot in killed[reused].tolist():
            assert int(slam.map.mp_first_seq[slot]) == int(slam.map.kf_seq[kf])
        kept = (res.frame.mp >= 0) & ~torch.isin(res.frame.mp, killed)
        assert torch.equal(row[kept], res.frame.mp[kept])
        settle(slam)
    finally:
        slam.shutdown()


def test_keyframe_reanchored_when_the_map_moved():
    """A keyframe whose frame was tracked on a snapshot is placed by the
    frame's pose relative to its reference keyframe when that keyframe moved
    in the live map meanwhile: after a rigid move W of the whole map (what a
    loop correction does to the drifted part), the new keyframe's pose is
    the frame's pose moved by W, and its depth points are the ones the
    unmoved append makes, moved by W (1e-4). Without a move the frame's pose
    is kept bit for bit. The reference appends the snapshot's pose in both
    cases."""
    from orb_slam2v2_1_tpu_torch.ops import lie

    cfg = config.SlamConfig(**DESK_KW)
    imgs, deps, _ = synthetic.desk_frames(cfg, synthetic.desk_trajectory(150)[:8], device="cpu")
    slam = instrument(system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, device="cpu", async_mapping=True))
    try:
        run_settled(slam, list(zip(imgs[:6], deps[:6])), slam.track_rgbd)

        def tracked(i):
            snap, _ = slam._box.read()
            return snap, frontend.process_frame_impl(
                snap, imgs[i], deps[i], slam.last_frame, slam._velocity_dev, slam._have_velocity, slam.ref_kf,
                slam._K, slam._dist, slam._bf, slam._depth_limit, i, slam._orb_cfg, cfg.width, cfg.height, slam.vocab)

        snap, res = tracked(6)
        slam._insert_keyframe_async(res, slam.ref_kf)
        assert torch.equal(slam.map.kf_pose[slam.ref_kf], res.frame.pose)
        settle(slam)

        snap, res = tracked(7)
        ref_kf = slam.ref_kf
        W = lie.se3_exp(torch.tensor([0.3, -0.2, 0.5, 0.05, 0.12, -0.08]))
        Winv = lie.se3_inverse(W)
        slam._box.mutate(lambda s: s._replace(kf_pose=s.kf_pose @ Winv, mp_pos=s.mp_pos @ W[:3, :3].T + W[:3, 3]))
        slam._insert_keyframe_async(res, ref_kf)
        kf = slam.ref_kf
        np.testing.assert_allclose(slam.map.kf_pose[kf].numpy(), (res.frame.pose @ Winv).numpy(), atol=1e-5)
        unmoved, kf_u = frontend.append_keyframe_only(snap, res.frame, slam._K, slam._bf, slam._depth_limit)
        assert int(kf_u) == kf and torch.equal(unmoved.kf_mp[kf], slam.map.kf_mp[kf])
        new = (unmoved.kf_mp[kf] >= 0) & ~torch.isin(unmoved.kf_mp[kf], snap.kf_mp[snap.kf_valid])
        ids = unmoved.kf_mp[kf][new].long()
        assert ids.numel() > 20
        np.testing.assert_allclose(slam.map.mp_pos[ids].numpy(),
                                   (unmoved.mp_pos[ids] @ W[:3, :3].T + W[:3, 3]).numpy(), atol=1e-4)
        settle(slam)
    finally:
        slam.shutdown()
