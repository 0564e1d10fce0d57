"""The port's spans and wait clocks (`orb_slam2v2_1_tpu_torch/spans.py`), on
the CPU.

- Spans nest: each records its parent (the span open on its thread), its
  thread's role and a key, its parent's where it is opened without one.
- The ring and the deques stay bounded; a system's deques survive `reset()`;
  a minute of spans at 60 frames/s does not fill a per-frame deque.
- The wait clock counts a read that did not wait as 0 and one that did as
  its wait, and the map's structural lock only where it was held.
- A `SlamSystem(async_mapping=True, pipelined=True)` on 12 orbit frames,
  waiting after each frame until the workers are idle, records `settle`,
  `frame_build`, `tracking` and the two wait counters once per `track_rgbd`
  call under that call's frame id (`tracking` from the first tracked frame;
  the first call initializes the map), and `map_queue` and `local_ba` once
  per mapping round under its keyframe id. With the recorder's appends made
  no-ops (but for the three clocks the system always kept: "track", "map",
  "loop") the same run gives the same samples of those clocks, the same
  counted reads by role and the same poses: no span reads the device.
"""

import collections
import threading
import time

import numpy as np
import pytest
import torch

from orb_slam2v2_1_tpu_torch import spans, sync
from orb_slam2v2_1_tpu_torch.models import system
from orb_slam2v2_1_tpu_torch.runtime.pipeline import MapBox
from orb_slam2v2_1_tpu_torch.utils import config, synthetic

torch.set_num_threads(2)

# fps=2: a keyframe at least every 2 frames, so pipelining engages on
# the 12 frames (5 keyframes).
KW = dict(fx=275.0, fy=275.0, cx=160.0, cy=120.0, width=320, height=240, n_features=700,
          max_keyframes=16, max_map_points=4096, fps=2.0, bf=44.0, th_depth=40.0)
N_FRAMES = 12
PER_FRAME = ("settle", "frame_build", "tracking", "decide", "track_read_wait", "track_map_wait")


def test_spans_nest_with_parents_roles_and_keys():
    rec = spans.Recorder()
    with rec.span("track", 7):
        with spans.span("nothing bound"):  # no recorder bound to this thread
            pass
        with spans.bind(rec):
            with spans.span("tracking"):
                with spans.span("inner", 3):
                    pass
        with rec.span("kf_insert") as s:
            s.key = 12
    with spans.span("outside"):
        pass

    def worker():
        sync.set_role("mapping")
        with rec.span("map", 5), spans.bind(rec), spans.span("local_ba"):
            pass

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    got = {s.name: s for s in rec.spans()}
    assert set(got) == {"track", "tracking", "inner", "kf_insert", "map", "local_ba"}
    assert got["track"][:4] == ("track", "tracker", 7, None)
    assert got["tracking"][:4] == ("tracking", "tracker", 7, "track")
    assert got["inner"][:4] == ("inner", "tracker", 3, "tracking")
    assert got["kf_insert"][:4] == ("kf_insert", "tracker", 12, "track")
    assert got["map"][:4] == ("map", "mapping", 5, None)
    assert got["local_ba"][:4] == ("local_ba", "mapping", 5, "map")
    tr, inner = got["track"], got["inner"]
    assert tr.start_ns <= got["tracking"].start_ns <= inner.start_ns <= inner.end_ns <= tr.end_ns
    assert tr.ms == pytest.approx((tr.end_ns - tr.start_ns) * 1e-6)
    # In the order they ended; `since_ns` keeps those that ended at or after it.
    assert [s.name for s in rec.spans()][:3] == ["inner", "tracking", "kf_insert"]
    assert [s.name for s in rec.spans(since_ns=got["kf_insert"].end_ns)] == ["kf_insert", "track", "local_ba", "map"]


def test_ring_and_deques_stay_bounded():
    assert spans.Recorder().ring.maxlen == spans.RING
    rec = spans.Recorder(collections.deque(maxlen=8))
    kept = rec.keep("frame_build", 4)
    assert rec.keep("frame_build", 99) is kept  # made once
    for k in range(100):
        with rec.span("frame_build", k):
            pass
        with rec.span("unkept", k):
            pass
    assert len(rec.ring) == 8 and len(kept) == 4 and set(rec.series) == {"frame_build"}
    assert [s.key for s in rec.spans()] == [96, 96, 97, 97, 98, 98, 99, 99]
    # A recorder that shares a ring keeps its own deques.
    other = spans.Recorder(rec.ring)
    other.keep("gba_solve", 8)
    with other.span("gba_solve"):
        pass
    assert rec.spans()[-1].name == "gba_solve" and "gba_solve" not in rec.series


def test_a_minute_at_60_frames_does_not_fill_a_per_frame_deque():
    stages = dict(system.STAGES)
    rec = spans.Recorder()
    for name, n in system.STAGES:
        rec.keep(name, n)
    for k in range(60 * 51 + 200):  # the window and a warm-up's worth
        with rec.call("track", k, "track_read_wait", "track_map_wait"):
            for name in ("settle", "frame_build", "tracking", "decide"):
                with spans.span(name):
                    pass
    for name in PER_FRAME:
        assert stages[name] >= 4096 and len(rec.series[name]) < rec.series[name].maxlen, name
    for name in ("kf_insert", "map_queue", "local_ba"):
        assert stages[name] >= 1024
    assert len(rec.series["track"]) == 512  # the old clock keeps its length


def test_wait_clock_counts_only_waits():
    rec = spans.Recorder()
    with rec.call("track", 3, "track_read_wait", "track_map_wait"):
        assert sync.AsyncRead(torch.arange(4)).numpy().tolist() == [0, 1, 2, 3]  # a CPU copy is ready: no wait
        assert len(rec.ring) == 0

        class _Late:  # a copy that has not arrived: numpy() waits for it
            def query(self):
                return False

            def synchronize(self):
                time.sleep(0.02)

        late = sync.AsyncRead(torch.arange(4))
        late._event = _Late()
        n = sync.COUNT["syncs"]
        late.numpy()
        assert sync.COUNT["syncs"] == n + 1
        box = MapBox(0)
        box.mutate(lambda s: s + 1)  # the lock was free: no wait
        assert [s.name for s in rec.spans()] == ["read_wait"]  # the late copy's
        held = threading.Event()

        def hold():
            with box._struct_lock:
                held.set()
                time.sleep(0.03)

        t = threading.Thread(target=hold)
        t.start()
        held.wait()
        assert box.mutate(lambda s: s + 1) == 2
        t.join()
    got = collections.defaultdict(list)
    for s in rec.spans():
        got[s.name].append(s)
    (rw,), (mw,) = got["read_wait"], got["map_wait"]
    assert rw[:4] == ("read_wait", "tracker", 3, "track") and rw.ms >= 19.0
    assert mw[:4] == ("map_wait", "tracker", 3, "track") and mw.ms >= 25.0
    (cr,), (cm,) = got["track_read_wait"], got["track_map_wait"]
    (call,) = got["track"]
    assert cr.ms == pytest.approx(rw.ms) and cm.ms == pytest.approx(mw.ms)
    assert (cr.key, cr.parent, cr.start_ns, cr.end_ns) == (3, "track", call.start_ns, call.end_ns)
    assert list(rec.series) == []  # none of these names is kept by this recorder


@pytest.fixture(scope="module")
def orbit():
    cfg = config.SlamConfig(**KW)
    imgs, deps, _ = synthetic.orbit_frames(cfg, N_FRAMES, device="cpu", total=321)
    return cfg, imgs.numpy(), deps.numpy()


def _idle(m, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not m.n_processed == m.n_loop_rounds == m.n_submitted:
        m.raise_worker_errors()
        assert time.monotonic() < deadline, "the async workers did not settle"
        time.sleep(0.002)


def _run(orbit):
    """The 12 frames through the production mode with a pose listener,
    settled after every call; returns the system (shut down), each call's
    frame id, the poses and the counted reads."""
    cfg, imgs, deps = orbit
    sync.reset()
    slam = system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, device="cpu", async_mapping=True,
                             pipelined=True)
    poses = {}
    slam.add_pose_listener(lambda p: poses.setdefault(p["timestamp"], p["Tcw"]))
    ids = []
    try:
        for i in range(N_FRAMES):
            ids.append(slam.frame_id)
            slam.track_rgbd(imgs[i], deps[i], i / 30)
            _idle(slam._mapper)
        slam.flush()
        _idle(slam._mapper)
        reads = (dict(sync.COUNT), dict(sync.BY_ROLE))
    finally:
        slam.shutdown()
    return slam, ids, poses, reads


@pytest.fixture(scope="module")
def recorded(orbit):
    return _run(orbit)


def test_system_records_each_call_and_each_round(recorded):
    slam, ids, poses, _ = recorded
    assert ids == list(range(N_FRAMES)) and len(poses) == N_FRAMES
    assert any(s.name == "settle" and s.ms > 0.1 for s in slam.spans())  # pipelining engaged
    by = collections.defaultdict(list)
    for s in slam.spans():
        by[s.name].append(s)
    calls = {s.key: s for s in by["track"]}
    assert sorted(calls) == ids and all(s.role == "tracker" and s.parent is None for s in calls.values())
    for name in ("settle", "frame_build", "tracking", "track_read_wait", "track_map_wait"):
        keys = [s.key for s in by[name] if s.parent == "track"]
        assert keys == (ids[1:] if name == "tracking" else ids), name  # the first call initializes
        for s in by[name]:
            call = calls[s.key]
            assert s.role == "tracker" and call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns, s
    for name in ("settle", "frame_build", "tracking"):
        assert len(slam._metrics[name]) == len(by[name])
    assert all(s.ms == 0.0 for s in by["track_map_wait"])  # settled: the lock was always free
    waits = collections.defaultdict(float)
    for s in by["read_wait"]:
        if s.role == "tracker":
            waits[s.key] += s.ms
    for s in by["track_read_wait"]:
        assert s.ms == pytest.approx(waits[s.key], abs=1e-6)
    # The mapping rounds: one queue span and one local BA each, by keyframe.
    rounds = [s.key for s in by["map"]]
    assert len(rounds) >= 4 and all(s.role == "mapping" for s in by["map"])
    assert sorted(rounds) == sorted(s.key for s in by["map_queue"]) == sorted(s.key for s in by["local_ba"])
    assert sorted(rounds) == sorted(s.key for s in by["kf_insert"])
    assert all(s.parent == "map" and s.role == "mapping" for s in by["local_ba"])
    assert all(s.parent is None and s.role == "mapping" and s.ms >= 0 for s in by["map_queue"])
    assert all(s.role == "loop" for s in by["loop"]) and len(by["loop"]) == len(rounds)
    for name in ("map", "loop", "map_queue", "local_ba", "kf_insert"):
        assert len(slam._metrics[name]) == len(by[name]), name


def test_spans_and_deques_survive_reset(orbit, recorded):
    cfg, imgs, deps = orbit
    slam = system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, device="cpu", async_mapping=True)
    try:
        rec, kept = slam._rec, dict(slam._metrics)
        slam.track_rgbd(imgs[0], deps[0], 0.0)
        slam.reset()
        assert slam._rec is rec and slam._metrics is rec.series
        assert all(slam._metrics[k] is v for k, v in kept.items())
        assert slam._mapper.recorder is rec and slam.loop_closer.gba_runner.recorder.ring is rec.ring
        slam.track_rgbd(imgs[1], deps[1], 0.1)
        assert len(slam._metrics["frame_build"]) == len(slam._metrics["track"]) == 2
        assert [s.key for s in slam.spans() if s.name == "track"] == [0, 1]  # reset keeps the frame count
    finally:
        slam.shutdown()


def test_recorder_adds_no_read_and_keeps_the_clocks(orbit, recorded, monkeypatch):
    slam, ids, poses, reads = recorded

    def old_clocks_only(self, name, key, parent, start_ns, end_ns, ms):
        if name in ("track", "map", "loop"):
            self.series[name].append(ms)

    monkeypatch.setattr(spans.Recorder, "add", old_clocks_only)
    bare, bare_ids, bare_poses, bare_reads = _run(orbit)
    assert bare.spans() == [] and bare_ids == ids
    for name in ("track", "map", "loop"):
        assert len(bare._metrics[name]) == len(slam._metrics[name]) > 0, name
    assert bare_reads == reads and reads[1]["tracker"] > 0 and reads[1]["mapping"] > 0
    assert sorted(bare_poses) == sorted(poses)
    for t, T in poses.items():
        np.testing.assert_array_equal(bare_poses[t], T)
