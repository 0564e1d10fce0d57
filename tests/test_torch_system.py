"""The online entry point, `models/system.py SlamSystem`, on both packages (CPU).

Sync mode (`async_mapping=False, pipelined=False`) at 320x240 (fx=fy=275,
cx=160, cy=120, 16 keyframes, 4096 map points, the shared vocabulary and a
loop closer built by the constructor). 700 features, not 500: the depth
initializer wants 500 valid keypoints in one frame (`system.py:1339`), which
500 features never give at this size (431 on the orbit's first frame).

- RGB-D: frames 0-15 of the benchmark's orbit; stereo: steps 0-11 of
  `evaluate.py`'s dolly (bf=22, baseline 0.08 m, th_depth=100).
  Tolerances: the same `None` pattern, poses within 2 mm in camera center and
  0.05 deg in rotation, equal `n_kf_host`, equal `stats()` keys and counters.
- The early-loss reset (`tests/test_loop_reloc.py:103-120` at this size);
  the blackout that relocalizes is in `test_torch_reloc.py`.
- `track_motion_model(vo_points=True)` on a map and frames of the
  reference: masks and counts exact, pose 1e-4; `Trajectory` and `ate_rmse`
  (numpy in both) 1e-9.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.models import frontend as jfrontend
from orb_slam2v2_1_tpu.models import system as jsystem
from orb_slam2v2_1_tpu.models import tracking as jtracking
from orb_slam2v2_1_tpu.models.map_state import MapState as JMapState
from orb_slam2v2_1_tpu.ops import orb as jorb
from orb_slam2v2_1_tpu.utils import config as jconfig
from orb_slam2v2_1_tpu.utils import trajectory as jtraj

from orb_slam2v2_1_tpu_torch.models import map_state, system, tracking
from orb_slam2v2_1_tpu_torch.utils import config, synthetic, trajectory

torch.set_num_threads(2)

KW = dict(fx=275.0, fy=275.0, cx=160.0, cy=120.0, width=320, height=240, n_features=700,
          max_keyframes=16, max_map_points=4096, fps=10.0, bf=44.0, th_depth=100.0)
STEREO_KW = dict(KW, bf=22.0)
N_RGBD, N_STEREO = 16, 12


def _pair(kw):
    return jconfig.SlamConfig(**kw), config.SlamConfig(**kw)


def _centers(poses):
    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])


def assert_poses_close(got, ref, mm=2.0, deg=0.05):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    dc = np.linalg.norm(_centers(got) - _centers(ref), axis=1)
    assert dc.max() <= mm * 1e-3, dc
    R = np.einsum("fji,fjk->fik", got[:, :3, :3], ref[:, :3, :3])
    ang = np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert ang.max() <= deg, ang


@pytest.fixture(scope="module")
def orbit():
    imgs, deps, gt = synthetic.orbit_frames(config.SlamConfig(**KW), N_RGBD + 1, device="cpu", total=321)
    return imgs.numpy(), deps.numpy(), gt


def _run(slam, frames, track):
    return [track(slam)(a, b, i * 0.1) for i, (a, b) in enumerate(frames)]


@pytest.fixture(scope="module")
def rgbd_runs(orbit):
    imgs, deps, _ = orbit
    jcfg, tcfg = _pair(KW)
    frames = list(zip(imgs[:N_RGBD], deps[:N_RGBD]))
    jslam = jsystem.SlamSystem(config=jcfg, sensor=jsystem.Sensor.RGBD)
    tslam = system.SlamSystem(config=tcfg, sensor=system.Sensor.RGBD, device="cpu")
    samples = []
    tslam.add_pose_listener(samples.append)
    jout = _run(jslam, frames, lambda s: s.track_rgbd)
    tout = _run(tslam, frames, lambda s: s.track_rgbd)
    return jslam, tslam, jout, tout, samples


@pytest.fixture(scope="module")
def stereo_runs():
    jcfg, tcfg = _pair(STEREO_KW)
    left, right, gt = synthetic.stereo_dolly_frames(tcfg, range(N_STEREO), np.random.default_rng(3), device="cpu")
    frames = list(zip(left.numpy(), right.numpy()))
    jslam = jsystem.SlamSystem(config=jcfg, sensor=jsystem.Sensor.STEREO)
    tslam = system.SlamSystem(config=tcfg, sensor=system.Sensor.STEREO, device="cpu")
    return jslam, tslam, _run(jslam, frames, lambda s: s.track_stereo), _run(tslam, frames, lambda s: s.track_stereo), gt


def _assert_runs_agree(jslam, tslam, jout, tout):
    assert [o is None for o in tout] == [o is None for o in jout]
    assert_poses_close([o for o in tout if o is not None], [o for o in jout if o is not None])
    assert tslam.n_kf_host == jslam.n_kf_host >= 2
    js, ts = jslam.stats(), tslam.stats()
    assert set(ts) == set(js)
    for key in ("state", "n_kf", "n_loops", "n_frames", "n_resets", "in_flight", "ba_skipped", "gba_ms_last"):
        assert ts[key] == js[key], key


def test_rgbd_parity(rgbd_runs):
    jslam, tslam, jout, tout, _ = rgbd_runs
    assert all(o is not None for o in jout)
    _assert_runs_agree(jslam, tslam, jout, tout)
    assert tslam.state == system.TrackState.OK and tslam.ref_kf == jslam.ref_kf


def test_stereo_parity(stereo_runs):
    """The dolly's 12 steps: every frame tracked in both, poses within 2 mm /
    0.05 deg of each other and 10 cm of the ground truth (at this size a wall
    at 7.8 m is 2.8 px of disparity: both packages are 4-7 cm off)."""
    jslam, tslam, jout, tout, gt = stereo_runs
    assert all(o is not None for o in jout)
    _assert_runs_agree(jslam, tslam, jout, tout)
    dc = np.linalg.norm(_centers(np.asarray(tout)) - _centers(gt), axis=1)
    assert dc.max() < 0.1, dc


def test_exports_parity(rgbd_runs, tmp_path):
    """The trajectory (relative to keyframes, resolved with the final
    keyframe poses), the keyframe pose array and the graph agree with the
    reference's; the TUM and KITTI files hold one line per tracked frame."""
    jslam, tslam, _, _, _ = rgbd_runs
    jabs = jslam.trajectory.absolute_poses(np.asarray(jslam.map.kf_pose))
    tabs = tslam.trajectory.absolute_poses(map_state.to_numpy(tslam.map)["kf_pose"])
    assert [t for t, _ in tabs] == [t for t, _ in jabs]
    assert_poses_close([np.linalg.inv(P) for _, P in tabs], [np.linalg.inv(P) for _, P in jabs])
    assert_poses_close(tslam.get_pose_array(), jslam.get_pose_array())
    tg, jg = tslam.get_graph(), jslam.get_graph()
    assert tg["posesId"] == jg["posesId"] and tg["links"] == jg["links"]
    assert [(e["fromId"], e["toId"]) for e in tg["covisibility"]] == [(e["fromId"], e["toId"]) for e in jg["covisibility"]]
    for e_t, e_j in zip(tg["covisibility"], jg["covisibility"]):
        assert abs(e_t["weight"] - e_j["weight"]) <= 0.02 * e_j["weight"]
    tslam.save_trajectory_tum(tmp_path / "t.txt")
    jslam.save_trajectory_tum(tmp_path / "j.txt")
    t_rows = np.loadtxt(tmp_path / "t.txt")
    j_rows = np.loadtxt(tmp_path / "j.txt")
    assert t_rows.shape == j_rows.shape == (N_RGBD, 8)
    np.testing.assert_allclose(t_rows, j_rows, atol=2e-3)
    tslam.save_trajectory_kitti(tmp_path / "t.kitti")
    assert np.loadtxt(tmp_path / "t.kitti").shape == (N_RGBD, 12)


def test_pose_listener_and_odometry(rgbd_runs):
    """One sample per frame with the reference's keys; the odometry chain
    (no loop closed, no relocalization) equals the last pose."""
    jslam, tslam, _, tout, samples = rgbd_runs
    assert len(samples) == N_RGBD
    assert set(samples[-1]) == {"timestamp", "Tcw", "odom", "state", "n_kf", "n_loops"}
    np.testing.assert_array_equal(samples[-1]["Tcw"], tout[-1])
    np.testing.assert_allclose(tslam.odom_pose, jslam.odom_pose, atol=2e-3)
    np.testing.assert_allclose(tslam.odom_pose, tout[-1], atol=1e-5)


def test_odom_step_parity(rng):
    """The device form of one odometry step against the reference's: 1e-5."""
    from orb_slam2v2_1_tpu.ops import lie as jlie

    xi = rng.normal(0, 0.2, (2, 6)).astype(np.float32)
    odom, diff = (np.array(jlie.se3_exp(jnp.asarray(x))) for x in xi)
    ref = np.asarray(jsystem._odom_step(jnp.asarray(odom), jnp.asarray(diff)))
    got = system._odom_step(torch.from_numpy(odom), torch.from_numpy(diff)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_early_loss_auto_reset(orbit):
    """Losing track within 5 keyframes of initialization wipes the young map
    and re-initializes on the next good frame, in both packages alike."""
    imgs, deps, _ = orbit
    black = (np.zeros_like(imgs[0]), np.zeros_like(deps[0]))
    frames = list(zip(imgs[:5], deps[:5])) + [black, (imgs[6], deps[6])]
    jcfg, tcfg = _pair(KW)
    jslam = jsystem.SlamSystem(config=jcfg, sensor=jsystem.Sensor.RGBD)
    tslam = system.SlamSystem(config=tcfg, sensor=system.Sensor.RGBD, device="cpu")
    jout = _run(jslam, frames, lambda s: s.track_rgbd)
    tout = _run(tslam, frames, lambda s: s.track_rgbd)
    for slam, out in ((jslam, jout), (tslam, tout)):
        assert out[5] is None and out[6] is not None and all(o is not None for o in out[:5])
        assert slam.n_resets == 1 and slam.n_kf_host == 1 and slam.state.name == "OK"
        assert len(slam.trajectory.entries) == 1
    np.testing.assert_array_equal(tout[6], np.eye(4, dtype=np.float32))


def test_localization_mode(orbit):
    """Localization only after frame 9: no keyframe is added afterwards, the
    temporal VO points take part in the motion model, and the poses agree."""
    imgs, deps, _ = orbit
    jcfg, tcfg = _pair(KW)
    outs = []
    for slam in (jsystem.SlamSystem(config=jcfg, sensor=jsystem.Sensor.RGBD),
                 system.SlamSystem(config=tcfg, sensor=system.Sensor.RGBD, device="cpu")):
        out = [slam.track_rgbd(imgs[i], deps[i], i * 0.1) for i in range(10)]
        n_kf = slam.n_kf_host
        slam.activate_localization_mode()
        out += [slam.track_rgbd(imgs[i], deps[i], i * 0.1) for i in range(10, 16)]
        assert slam.n_kf_host == n_kf and all(o is not None for o in out)
        slam.deactivate_localization_mode()
        assert not slam.localization_only
        outs.append(out)
    assert_poses_close(outs[1], outs[0])


def test_vo_points_parity(rgbd_runs, orbit):
    """`track_motion_model(vo_points=True)` on the reference's map, its last
    frame and frame 16 built by the reference: associations, match and
    inlier counts exact, pose 1e-4; VO points add matches."""
    jslam = rgbd_runs[0]
    imgs, deps, _ = orbit
    jcfg = jconfig.SlamConfig(**KW)
    K = jnp.asarray(jcfg.K, jnp.float32)
    cur = jfrontend.build_frame_only(
        jnp.asarray(imgs[16]), jnp.asarray(deps[16]), K, jnp.asarray(jcfg.dist, jnp.float32), jnp.float32(jcfg.bf),
        jnp.int32(16), jorb.OrbConfig(n_features=jcfg.n_features), True, jcfg.width, jcfg.height)
    last = jslam.last_frame
    T_pred = last.pose
    state = jslam.map
    t_state = map_state.from_numpy({n: np.asarray(v) for n, v in zip(JMapState._fields, state)}, device="cpu")

    def tframe(f):
        return tracking.frame_from_numpy({n: np.asarray(v) for n, v in zip(f._fields, f)}, device="cpu")

    Kt = torch.from_numpy(np.array(K))
    for vo in (True, False):
        rT, rmp, rst = jtracking.track_motion_model(state, cur, last, T_pred, K, jnp.float32(jcfg.bf),
                                                    jnp.float32(7.0), vo_points=vo)
        tT, tmp, tst = tracking.track_motion_model(t_state, tframe(cur), tframe(last), torch.from_numpy(np.array(T_pred)),
                                                   Kt, float(jcfg.bf), 7.0, vo_points=vo)
        np.testing.assert_array_equal(tmp.numpy(), np.asarray(rmp))
        assert int(tst.n_matches) == int(rst.n_matches) and int(tst.n_inliers) == int(rst.n_inliers)
        np.testing.assert_allclose(tT.numpy(), np.asarray(rT), atol=1e-4)
        if vo:
            n_vo = int(tst.n_matches)
        else:
            assert n_vo > int(tst.n_matches) >= 50


def test_trajectory_and_ate_parity(tmp_path, rng):
    """The port's `Trajectory` (append, append_rel with numpy and with a
    tensor, redirect_kf, lost entries) and `ate_rmse` against the
    reference's on the same records: 1e-9."""
    from orb_slam2v2_1_tpu.ops import lie as jlie

    def se3(x):
        return np.asarray(jlie.se3_exp(jnp.asarray(x, jnp.float32)), np.float64)

    kf = se3(rng.normal(0, 0.3, (4, 6)))
    frames = se3(rng.normal(0, 0.3, (12, 6)))
    jt, tt = jtraj.Trajectory(), trajectory.Trajectory()
    for i, Tcw in enumerate(frames):
        ref_kf = i % 4
        T_rel = Tcw @ np.linalg.inv(kf[ref_kf])
        if i % 3 == 0:
            jt.append(i * 0.1, ref_kf, Tcw, kf[ref_kf])
            tt.append(i * 0.1, ref_kf, Tcw, kf[ref_kf])
        else:
            jt.append_rel(i * 0.1, ref_kf, jnp.asarray(T_rel, jnp.float32), lost=i == 5)
            tt.append_rel(i * 0.1, ref_kf, torch.from_numpy(T_rel.astype(np.float32)), lost=i == 5)
    T_red = se3(rng.normal(0, 0.1, 6))
    jt.redirect_kf(2, 1, T_red)
    tt.redirect_kf(2, 1, T_red)
    ja, ta = jt.absolute_poses(kf), tt.absolute_poses(kf)
    assert [t for t, _ in ta] == [t for t, _ in ja] and len(ta) == 11
    for (_, a), (_, b) in zip(ta, ja):
        np.testing.assert_allclose(a, b, atol=1e-9)
    assert [e.ref_kf for e in tt.entries] == [e.ref_kf for e in jt.entries]
    gt = {t: P @ se3(rng.normal(0, 0.01, 6)) for t, P in ja}
    for scale in (True, False):
        assert abs(trajectory.ate_rmse(ta, gt, align_scale=scale) - jtraj.ate_rmse(ja, gt, align_scale=scale)) <= 1e-9
    assert trajectory.ate_rmse(ta[:2], gt) == float("inf")
    tt.save_kitti(tmp_path / "t.kitti", kf)
    jt.save_kitti(tmp_path / "j.kitti", kf)
    assert (tmp_path / "t.kitti").read_text() == (tmp_path / "j.kitti").read_text()
    tt.save_tum(tmp_path / "t.tum", kf)
    jt.save_tum(tmp_path / "j.tum", kf)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t.tum"), np.loadtxt(tmp_path / "j.tum"), atol=2e-7)


def _spy(monkeypatch, module, name):
    """Count the calls of `module.name` (the function stays the same)."""
    calls, real = [], getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("kwargs, match", [
    (dict(sensor=system.Sensor.RGBD, async_mapping=True), None),
    (dict(sensor=system.Sensor.RGBD, async_mapping=True, pipelined=True), None),
    (dict(sensor=system.Sensor.MONOCULAR, async_mapping=True), None),
    (dict(sensor=system.Sensor.STEREO, mesh=["cpu", "cpu"]), "mesh"),
])
def test_unported_modes_raise(kwargs, match, monkeypatch):
    """Every mode builds. The async and pipelined modes start their workers
    and stop them. A stereo system with a mesh of two shards (ported since)
    holds it, hands it to its loop closer, and solves a keyframe's local BA
    window through the sharded route."""
    if match is not None:
        from orb_slam2v2_1_tpu_torch.models import local_mapping

        calls = _spy(monkeypatch, local_mapping, "local_bundle_adjustment_dist")
        cfg = config.SlamConfig(**STEREO_KW)
        slam = system.SlamSystem(config=cfg, device="cpu", **kwargs)
        assert slam.mesh.size == 2 and slam.loop_closer.mesh is slam.mesh
        left, right, _ = synthetic.stereo_dolly_frames(cfg, range(1), np.random.default_rng(3), device="cpu")
        assert slam.track_stereo(left[0].numpy(), right[0].numpy(), 0.0) is not None  # initializes the map
        slam._insert_keyframe_fused(slam.last_frame)
        assert calls == [1] and slam.n_kf_host == 2
        assert torch.isfinite(slam.map.kf_pose[:2]).all()
        return
    slam = system.SlamSystem(config=config.SlamConfig(**KW), device="cpu", **kwargs)
    try:
        assert slam._mapper is not None and slam.loop_closer.detached_gba
        assert slam.stats()["in_flight"] == 0 and slam.stats()["ba_skipped"] == 0
    finally:
        slam.shutdown()
    assert slam._mapper is None and slam._box is None


def test_unported_methods_raise_and_pipelined_needs_async(tmp_path, monkeypatch):
    """Pipelining needs async mode. A system with a mesh of two shards
    (ported since) builds, and its loop closer's global BA goes through the
    sharded route. The map server calls run (ported since): connect, stream
    the initial keyframe, fetch it back and start LOST in it. `save_map`,
    `load_map` and `warmup` run."""
    from orb_slam2v2_1_tpu_torch.models import loop_closing
    from orb_slam2v2_1_tpu_torch.parallel.stream import MapServerNode

    with pytest.raises(ValueError, match="async_mapping"):
        system.SlamSystem(config=config.SlamConfig(**KW), sensor=system.Sensor.RGBD, pipelined=True, device="cpu")
    cfg = config.SlamConfig(**KW)
    imgs, deps, _ = synthetic.orbit_frames(cfg, 1, device="cpu", total=321)
    meshed = system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, mesh=["cpu", "cpu"], device="cpu")
    assert meshed.mesh.size == 2 and meshed.loop_closer.mesh is meshed.mesh
    assert meshed.track_rgbd(imgs[0], deps[0], 0.0) is not None
    calls = _spy(monkeypatch, loop_closing, "global_bundle_adjustment_dist")
    state, cost = loop_closing.run_global_bundle_adjustment(meshed.map, meshed._K, meshed._bf,
                                                            mesh=meshed.loop_closer.mesh)
    assert calls == [1] and bool(torch.isfinite(cost)) and torch.isfinite(state.kf_pose).all()
    node = MapServerNode(port=0, max_kf=cfg.max_keyframes, max_mp=cfg.max_map_points, n_kp=cfg.n_features,
                         device="cpu")
    slam = system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, device="cpu")
    try:
        slam.connect_server("127.0.0.1", node.port, 4)
        assert slam.poll_server_push() is False
        assert slam.track_rgbd(imgs[0], deps[0], 0.0) is not None  # initializes the map
        slam._stream_keyframe()
        slam.fetch_server_map()
        assert slam.state == system.TrackState.LOST and slam.n_kf_host == 1
        np.testing.assert_allclose(slam.map.kf_pose[0].numpy(), node.server.client_map(4).kf_pose[0].numpy())
        assert node.n_deltas == 2  # the keyframe and its pose update
    finally:
        slam.shutdown()
        node.stop()
    slam = system.SlamSystem(config=config.SlamConfig(**KW), sensor=system.Sensor.RGBD, device="cpu")
    slam.warmup(gba_buckets=(16,))
    slam.save_map(tmp_path / "empty.npz")
    slam.load_map(tmp_path / "empty.npz")
    assert slam.state == system.TrackState.LOST and slam.n_kf_host == 0
    slam.flush()
    slam.shutdown()
    assert slam.stats()["state"] == "LOST" and slam.loop_closer is not None
