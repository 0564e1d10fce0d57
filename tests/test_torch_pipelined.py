"""Pipelined tracking and `warmup` in the port (CPU).

- The deferred decision logic, exact against the reference's: a recorded
  sequence of decision vectors through both packages' `_drain_pending` /
  `_process_pending` with a window of 4 frames (close-decay anticipation,
  keyframe triggers under lag, the transient-dip grace budget, loss, a loop
  closed in the background, the device-side odometry chain); the keyframes
  the same frames, except that where the reference makes a keyframe of an
  in-flight frame whose tracking failed, the port makes it of the frame it
  is deciding; and
  `_need_new_keyframe_stats(stats, frame_id, lag)` and `_update_health` on a
  grid of inputs. The workers, the box and the keyframe insertion are
  stand-ins, so only the host logic runs.
- The invariants of `tests/test_pipelined.py:45-117` in the port: no frame
  dropped, `flush` empties the window, the health gate keeps pipelining off
  under 5 keyframes, the TUM export after `flush`.
- `warmup` leaves `map`, `trajectory`, `frame_id`, `state`, `kf_db` and the
  loop closer's database exactly as it found them.
"""

import collections
import itertools
import time
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.models import system as jsystem
from orb_slam2v2_1_tpu.ops import lie as jlie
from orb_slam2v2_1_tpu.utils import config as jconfig

from orb_slam2v2_1_tpu_torch import sync
from orb_slam2v2_1_tpu_torch.models import keyframe_database as kdb
from orb_slam2v2_1_tpu_torch.models import map_state, system
from orb_slam2v2_1_tpu_torch.utils import config, synthetic

torch.set_num_threads(2)

KW = dict(fx=275.0, fy=275.0, cx=160.0, cy=120.0, width=320, height=240, n_features=700,
          max_keyframes=16, max_map_points=4096, fps=10.0, bf=44.0, th_depth=40.0)


class _Box:
    """Stand-in MapBox: every publish lands."""

    def __init__(self):
        self.version = 0

    def publish(self, state, expected_version=None):
        self.version += 1
        return True

    def read(self):
        return None, self.version


class _Stats:
    """A decision vector whose copy never reports ready: the window drains
    only when it is over its depth (or forced), as on a busy card."""

    def __init__(self, a):
        self.a = np.asarray(a, np.float32)

    def is_ready(self):
        return False

    def numpy(self):
        return self.a

    def __array__(self, dtype=None, copy=None):
        return self.a


def _stats_sequence(rng, n=60):
    """Tracked frames whose close-point count decays, with dips of 15-29
    inliers (grace), a run of dips that exhausts the grace, and frames under
    the 60-inlier health bar."""
    rows = []
    close = 400.0
    for k in range(n):
        close = close - rng.uniform(0, 30) if close > 120 else 400.0
        inl = float(rng.integers(40, 200))
        tracked = 1.0
        if k in (11, 23, 24, 40, 41, 42):
            tracked, inl = 0.0, float(rng.integers(15, 30))
        rows.append([tracked, inl, inl + 20, float(rng.integers(100, 260)), close, float(rng.integers(40, 120)),
                     0.0, inl, inl])
    return rows


def _poses(rng, n):
    xi = rng.normal(0, 0.05, (n, 6)).astype(np.float32)
    return [np.asarray(jlie.se3_exp(jnp.asarray(x))) for x in xi]


# A stand-in FrameResult with only the fields `_process_pending` reads.
Res = collections.namedtuple("Res", "state frame pose T_rel velocity stats")


def _drive(slam, make_pending, rows, loop_at):
    """Enqueue each recorded frame as `_enqueue_pending` does and drain as
    `_step` does; returns the per-frame record of the decision state, the
    keyframe insertions (frame id at insertion, the frame inserted), the
    resets and the trajectory's lost flags."""
    slam._box = _Box()
    slam._mapper = types.SimpleNamespace(n_loops=0, raise_worker_errors=lambda: None)
    slam.loop_closer = None
    slam.n_kf_host = 6
    slam.state = type(slam.state).OK
    inserted, resets = [], []

    def insert(frame_or_res, *ref_kf):
        # The reference passes the frame (here its tag), the port the
        # frame's result and its reference keyframe.
        inserted.append((slam.frame_id, getattr(frame_or_res, "frame", frame_or_res), deciding[-1]))
        slam.last_kf_frame = slam.frame_id

    slam._insert_keyframe_async = insert
    slam.reset = lambda: resets.append(slam.frame_id)
    process = slam._process_pending

    def process_logged(e):
        deciding.append(e.frame_id)
        return process(e)

    deciding = []
    slam._process_pending = process_logged
    log = []
    for k, row in enumerate(rows):
        if k == loop_at:
            slam._mapper.n_loops = 1
        slam._pending.append(make_pending(k, row))
        slam.frame_id = k + 1
        slam._drain_pending()
        log.append((len(slam._pending), slam._grace_left, round(slam._close_decay, 5), slam._pipeline_healthy,
                    slam._have_velocity, slam._odom_skip_next, slam.state.name, slam.n_loops_closed))
    slam._drain_pending(force=True)
    return log, inserted, resets, [e.lost for e in slam.trajectory.entries]


@pytest.mark.parametrize("untracked_newest", [False, True])
def test_pipelined_decisions_parity(untracked_newest):
    """With `untracked_newest`, the frames in flight at the first two
    keyframe triggers (frames 4 and 10, the newest when frames 0 and 6 are
    decided) are dips: the reference makes keyframes of them, the port of
    the decided frames."""
    rng = np.random.default_rng(5)
    rows = _stats_sequence(rng)
    if untracked_newest:
        for k in (4, 10):
            rows[k] = [0.0, 20.0, 40.0] + rows[k][3:7] + [20.0, 20.0]
    vel, pose = _poses(rng, len(rows)), _poses(rng, len(rows))

    def jpending(k, row):
        res = Res(None, k, jnp.asarray(pose[k]), jnp.asarray(pose[k]), jnp.asarray(vel[k]), _Stats(row))
        return jsystem._Pending(res, k * 0.1, k, 3, 0)

    def tpending(k, row):
        res = Res(None, k, torch.tensor(pose[k]), torch.tensor(pose[k]), torch.tensor(vel[k]), None)
        return system._Pending(res, _Stats(row), k * 0.1, k, 3, 0)

    jslam = jsystem.SlamSystem(config=jconfig.SlamConfig(**KW), sensor=jsystem.Sensor.RGBD)
    tslam = system.SlamSystem(config=config.SlamConfig(**KW), sensor=system.Sensor.RGBD, device="cpu")
    ref = _drive(jslam, jpending, rows, loop_at=30)
    got = _drive(tslam, tpending, rows, loop_at=30)
    assert got[0] == ref[0]
    # The same insertions at the same moments, of the same frame, except
    # where the reference inserts an in-flight frame whose tracking failed:
    # the port inserts the frame it was deciding instead.
    untracked = [(at, newest) for at, newest, _ in ref[1] if rows[newest][0] == 0]
    expected = [(at, newest if rows[newest][0] > 0 else decided, decided) for at, newest, decided in ref[1]]
    assert got[1] == expected and len(got[1]) >= 3
    assert [newest for _, newest in untracked] == ([4, 10] if untracked_newest else [])
    assert got[2] == ref[2] and got[3] == ref[3]
    log = got[0]
    assert any(r[1] == 1 for r in log) and any(not r[3] for r in log) and any(r[0] == 4 for r in log)
    assert log[-1][7] == 1  # the loop closed in the background was taken up
    assert sum(got[3]) >= 3  # the run that exhausts the grace is lost, with the frames in flight behind it
    # The odometry chain: a product of ~55 float32 steps, each within 1e-5
    # of the reference's (test_torch_system.py::test_odom_step_parity).
    np.testing.assert_allclose(tslam.odom_pose, jslam.odom_pose, atol=1e-4)


@pytest.mark.parametrize("sensor", ["RGBD", "MONOCULAR"])
def test_need_new_keyframe_stats_parity(sensor):
    kw = dict(KW, bf=0.0) if sensor == "MONOCULAR" else KW
    jslam = jsystem.SlamSystem(config=jconfig.SlamConfig(**kw), sensor=jsystem.Sensor[sensor])
    tslam = system.SlamSystem(config=config.SlamConfig(**kw), sensor=system.Sensor[sensor], device="cpu")
    for slam in (jslam, tslam):
        slam.frame_id, slam.last_kf_frame, slam.n_kf_host = 40, 33, 6
    grid = itertools.product([10.0, 16.0, 80.0, 150.0], [100.0, 200.0], [60.0, 99.0, 100.0, 130.0], [50.0, 71.0],
                             [None, 35, 43], [0, 1, 3], [0.0, 2.5, 12.0])
    n_true = 0
    for inl, ref_m, close, untracked, fid, lag, decay in grid:
        stats = np.array([1, inl, inl, ref_m, close, untracked, 0, inl, inl], np.float32)
        jslam._close_decay = tslam._close_decay = decay
        want = jslam._need_new_keyframe_stats(stats, frame_id=fid, lag=lag)
        assert tslam._need_new_keyframe_stats(stats, frame_id=fid, lag=lag) == want, (inl, ref_m, close, fid, lag)
        n_true += bool(want)
    assert 0 < n_true
    for tracked, inl, n_kf in itertools.product([False, True], [59.0, 60.0, 200.0], [4, 5, 9]):
        jslam.n_kf_host = tslam.n_kf_host = n_kf
        jslam._update_health(tracked, np.array([tracked, inl], np.float32))
        tslam._update_health(tracked, np.array([tracked, inl], np.float32))
        assert tslam._pipeline_healthy == jslam._pipeline_healthy == (tracked and inl >= 60 and n_kf >= 5)


def test_pipelined_requires_async():
    with pytest.raises(ValueError, match="async_mapping"):
        system.SlamSystem(config=config.SlamConfig(**KW), sensor=system.Sensor.RGBD, pipelined=True, device="cpu")


@pytest.fixture(scope="module")
def desk():
    cfg = config.SlamConfig(**dict(KW, fps=2.0))
    imgs, deps, gt = synthetic.desk_frames(cfg, synthetic.desk_trajectory(150)[:16], device="cpu")
    return cfg, imgs.numpy(), deps.numpy(), gt


def test_pipelined_tracks_and_flushes(desk, tmp_path):
    """16 desk frames at fps=2 (a keyframe at least every 2 frames, so the
    health gate opens after the fifth): every frame has a pose and a
    trajectory entry, pipelining engaged (poses returned as tensors, frames
    in flight), `flush` empties the window, the poses stay on the ground
    truth, and the TUM export holds every frame."""
    cfg, imgs, deps, gt = desk
    slam = system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, device="cpu", async_mapping=True,
                             pipelined=True)
    outs, in_flight, active = [], [], []
    try:
        for i in range(len(imgs)):
            outs.append(slam.track_rgbd(imgs[i], deps[i], i * 0.1))
            in_flight.append(slam.stats()["in_flight"])
            active.append(slam._pipelining_active())
            if slam.n_kf_host < 5:
                assert not slam._pending  # the health gate: no pipelining on a young map
        slam.flush()
        assert not slam._pending and slam.stats()["in_flight"] == 0
        assert slam.state == system.TrackState.OK and slam.n_resets == 0
        assert all(o is not None for o in outs) and len(slam.trajectory.entries) == len(imgs)
        assert any(isinstance(o, torch.Tensor) for o in outs) and max(in_flight) >= 1 and any(active)
        est = np.stack([np.asarray(o, np.float64) for o in outs])
        dc = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
        assert dc.max() < 0.02, dc
        slam.save_trajectory_tum(tmp_path / "t.txt")
        assert len((tmp_path / "t.txt").read_text().splitlines()) == len(imgs)
        assert slam.n_kf_host >= 5 and slam.stats()["map_ms_p50"] is not None
    finally:
        slam.shutdown()
    assert slam._mapper is None and not slam._pending


def test_health_gate_defers_pipelining(desk):
    cfg, imgs, deps, _ = desk
    slam = system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, device="cpu", async_mapping=True,
                             pipelined=True)
    try:
        slam.track_rgbd(imgs[0], deps[0], 0.0)
        assert not slam._pipelining_active()  # n_kf < 5: still sync
        for i in range(1, 4):
            slam.track_rgbd(imgs[i], deps[i], i * 0.1)
            assert not slam._pending or slam.n_kf_host >= 5
    finally:
        slam.shutdown()


def _wait_idle(m, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not m.n_processed == m.n_loop_rounds == m.n_submitted:
        m.raise_worker_errors()
        assert time.monotonic() < deadline, "the async workers did not settle"
        time.sleep(0.002)


def _snapshot(slam):
    db = slam.loop_closer.db if slam.loop_closer is not None else None
    return {"map": map_state.to_numpy(slam.map), "kf_db": kdb.database_to_numpy(slam.kf_db),
            "closer_db": kdb.database_to_numpy(db), "frame_id": slam.frame_id, "state": slam.state,
            "ref_kf": slam.ref_kf, "n_kf": slam.n_kf_host,
            "trajectory": [(e.timestamp, e.ref_kf, np.asarray(e.T_rel).copy(), e.lost) for e in slam.trajectory.entries]}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            for f in a[k]:
                np.testing.assert_array_equal(a[k][f], b[k][f], err_msg=f"{k}.{f}")
        elif k == "trajectory":
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                assert x[0] == y[0] and x[1] == y[1] and x[3] == y[3]
                np.testing.assert_array_equal(x[2], y[2])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("sensor, mode", [("RGBD", "pipelined"), ("STEREO", "sync"), ("MONOCULAR", "async")])
def test_warmup_leaves_state_unchanged(desk, sensor, mode):
    """After a few tracked frames, `warmup` runs every program once and the
    system's state is what it was; tracking then goes on."""
    cfg, imgs, deps, _ = desk
    if sensor == "MONOCULAR":
        cfg = config.SlamConfig(**dict(KW, bf=0.0))
    slam = system.SlamSystem(config=cfg, sensor=system.Sensor[sensor], device="cpu",
                             async_mapping=mode != "sync", pipelined=mode == "pipelined")

    def track(i):
        if sensor == "STEREO":
            return slam.track_stereo(imgs[i], imgs[i], i * 0.1)
        if sensor == "MONOCULAR":
            return slam.track_monocular(imgs[i], i * 0.1)
        return slam.track_rgbd(imgs[i], deps[i], i * 0.1)

    try:
        for i in range(3):
            track(i)
        slam.flush()
        if slam._mapper is not None:
            _wait_idle(slam._mapper)  # the workers' rounds for those frames are done
        before = _snapshot(slam)
        sync.reset()
        slam.warmup(gba_buckets=(16, 32), verbose=True)
        assert sync.COUNT["syncs"] > 0
        _assert_same(before, _snapshot(slam))
        track(3)
        assert slam.frame_id == 4
    finally:
        slam.shutdown()
