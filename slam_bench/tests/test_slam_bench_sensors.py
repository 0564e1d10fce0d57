"""The three sensors through the harness: what the window calls on the
system for each, and what the correctness check computes for each on a
made-up run (`slam_bench_synthetic.py`)."""

import numpy as np
import pytest
import torch

import slam_bench_synthetic as syn
from slam_bench import check, sensors, stream, window
from slam_bench.manifest import Manifest, load
from slam_bench_copy import SAMPLES

ALL = {name: 1.0 for name in check.NUMBERS}
# What the parent commit's `check.judge` gave on `syn.run(syn.session(),
# rot_deg=20, shift=(0.3, -0.2, 1.0), noise=0.01, orb_faults=3)` with the
# seed 5; the rigid sensors' numbers must not move.
PINNED = {"unanswered": 1.0, "ate_m": 0.01905560687562033, "rot_rmse_deg": 1.0866184690801668,
          "map_point_m": 0.015482788538912887, "orb_keypoints_differ": 0.01, "orb_bits_differ": 0.0032837127845884414}
# The same inputs scaled by 0.37: the parent commit's rigid alignment.
PINNED_SCALED = {"unanswered": 1.0, "ate_m": 0.1527715214451426, "rot_rmse_deg": 0.0,
                 "map_point_m": 4.95605618755024, "orb_keypoints_differ": 0.0, "orb_bits_differ": 0.0}


@pytest.fixture(scope="module")
def sess():
    return syn.session()


class StubSystem:
    """Records every call the window makes; no program."""

    def __init__(self, config=None, sensor=None, **kw):
        self.config, self.sensor, self.kw = config, sensor, kw
        self.frame_id, self.calls = 0, []

    def __getattr__(self, name):
        if not name.startswith("track_"):
            raise AttributeError(name)

        def track(*images, timestamp):
            self.calls.append((name, images, timestamp))
            self.frame_id += 1
        return track


@pytest.mark.parametrize("sensor", sorted(sensors.SENSORS))
def test_each_sensor_calls_its_entry_point(monkeypatch, sess, sensor):
    from orb_slam2v2_1_tpu_torch.models import system

    monkeypatch.setattr(system, "SlamSystem", StubSystem)
    slam = window.build_system(Manifest().config("tum_rgbd")["slam"], sensor, "cpu")
    assert slam.sensor is system.Sensor[sensors.SENSORS[sensor].member]
    assert slam.kw == {"async_mapping": True, "pipelined": True, "device": "cpu"}
    second = None if sensor == "monocular" else sess.second
    s = sess._replace(second=second)
    win = window.Window(seconds=1.0, rate_hz=30.0)
    win.frame_of_id.append({})
    window.preroll(win, slam, s, sensor, 3)
    expected = {"rgbd": "track_rgbd", "stereo": "track_stereo", "monocular": "track_monocular"}[sensor]
    assert [c[0] for c in slam.calls] == [expected] * 3
    for k, (_, images, ts) in enumerate(slam.calls):
        assert ts == pytest.approx(k / 30.0)
        assert torch.equal(images[0], sess.first[k])
        if sensor == "monocular":
            assert len(images) == 1
        else:
            assert len(images) == 2 and torch.equal(images[1], sess.second[k])
    assert win.frame_of_id[0] == {0: 0, 1: 1, 2: 2}


def test_monocular_session_renders_no_second_image():
    man = Manifest()
    slam_cfg = dict(man.config("tum_rgbd")["slam"], width=80, height=60, fx=68.75, fy=68.75, cx=40.0, cy=30.0)
    traffic = dict(man.traffic("orbit_explore"), frames=[0, 3])
    rgbd = stream.render_session(slam_cfg, "rgbd", traffic, 7, "cpu")
    mono = stream.render_session(slam_cfg, "monocular", dict(traffic, sensor="monocular"), 7, "cpu")
    assert mono.second is None and rgbd.second is rgbd.depth
    for a, b in zip((mono.first, mono.depth, mono.gt, mono.timestamps),
                    (rgbd.first, rgbd.depth, rgbd.gt, rgbd.timestamps)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("sensor", ["rgbd", "stereo"])
def test_rigid_sensors_read_what_the_parent_read(sess, sensor):
    win, maps = syn.run(sess, rot_deg=20.0, shift=(0.3, -0.2, 1.0), noise=0.01, orb_faults=3)
    _, rows, numbers = check.judge(win, maps, sess, syn.config(sensor), ALL, 5)
    assert {name: v for name, v, _ in rows} == PINNED
    assert "scale_by_session" not in numbers
    win, maps = syn.run(sess, scale=0.37, rot_deg=20.0, shift=(0.3, -0.2, 1.0))
    _, rows, _ = check.judge(win, maps, sess, syn.config(sensor), ALL, 5)
    assert {name: v for name, v, _ in rows} == PINNED_SCALED


def test_monocular_aligns_each_session_by_a_similarity(sess):
    """The truth scaled by 0.37 and moved rigidly: the monocular check reads
    it as the truth, the rigid one does not."""
    win, maps = syn.run(sess, scale=0.37, rot_deg=20.0, shift=(0.3, -0.2, 1.0))
    _, rows, numbers = check.judge(win, maps, sess, syn.config("monocular"), ALL, 5)
    mono = {name: v for name, v, _ in rows}
    assert mono["ate_m"] < 1e-6 and mono["map_point_m"] < 1e-6
    assert numbers["scale_by_session"] == pytest.approx({0: 1 / 0.37, 1: 1 / 0.37})
    _, rows, _ = check.judge(win, maps, sess, syn.config("rgbd"), ALL, 5)
    rigid = {name: v for name, v, _ in rows}
    assert rigid["ate_m"] > 0.1 and rigid["map_point_m"] > 1.0
    # The scale-free numbers are the same for both.
    for name in ("unanswered", "rot_rmse_deg", "orb_keypoints_differ", "orb_bits_differ"):
        assert mono[name] == rigid[name]


def test_monocular_initializer_frames_and_short_sessions(sess):
    """A monocular session's frames before its first pose are its
    initializer's, not unanswered; a session with fewer than 3 poses has no
    scale, and its keyframes are left out of the map's number."""
    sessions = ({"frames": 10, "keyframes": (3, 7), "unpublished": (0, 1, 2, 8), "lost": ()},
                {"frames": 4, "keyframes": (0,), "unpublished": (0, 1, 2), "lost": ()})
    win, maps = syn.run(sess, scale=2.5, sessions=sessions)
    _, rows, numbers = check.judge(win, maps, sess, syn.config("monocular"), ALL, 5)
    mono = {name: v for name, v, _ in rows}
    assert mono["unanswered"] == 1.0  # frame 8 of the first session
    assert set(numbers["scale_by_session"]) == {0}
    assert set(numbers["map_point_m_by_session"]) == {0} and mono["map_point_m"] < 1e-6
    _, rows, numbers = check.judge(win, maps, sess, syn.config("rgbd"), ALL, 5)
    assert dict((n, v) for n, v, _ in rows)["unanswered"] == 7.0
    assert set(numbers["map_point_m_by_session"]) == {0, 1}


@pytest.mark.parametrize("where", ["middle", "last"])
def test_a_monocular_session_that_never_initialized(sess, where):
    """A session before the window's last that published no pose never
    initialized: every frame of it is unanswered and the run is not correct.
    The window's close may have cut the last before it initialized: its
    frames are not counted, and the sample `first_pose_frame` reads the
    frames submitted in it."""
    full = {"frames": 10, "keyframes": (0, 3, 7), "unpublished": (), "lost": ()}
    never = {"frames": 6, "keyframes": (0,), "unpublished": tuple(range(6)), "lost": ()}
    sessions = (full, never, full) if where == "middle" else (full, full, never)
    win, maps = syn.run(sess, scale=2.5, sessions=sessions)
    checks = {"first_pose_frame": load(SAMPLES, "checks", "first_pose_frame", "number")}
    limits = {"unanswered": 0, "ate_m": 1e-6, "first_pose_frame": 24}
    ok, rows, numbers = check.judge(win, maps, sess, syn.config("monocular"), limits, 5, checks)
    got = {name: v for name, v, _ in rows}
    assert got["ate_m"] < 1e-6
    if where == "middle":
        assert got["unanswered"] == 6.0 and got["first_pose_frame"] == float("inf") and not ok
        assert set(numbers["scale_by_session"]) == {0, 2}
    else:
        assert got["unanswered"] == 0.0 and got["first_pose_frame"] == 6.0 and ok
        assert set(numbers["scale_by_session"]) == {0, 1}


def test_every_sensor_has_an_entry_point_of_the_program():
    from orb_slam2v2_1_tpu_torch.models.system import Sensor, SlamSystem

    assert {s.member for s in sensors.SENSORS.values()} == {m.name for m in Sensor}
    for spec in sensors.SENSORS.values():
        assert callable(getattr(SlamSystem, spec.track))
    with pytest.raises(ValueError, match="slam_bench/sensors.py"):
        sensors.spec("sonar")
