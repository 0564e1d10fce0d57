"""One run of a cell: set-up, the measured window, and what it leaves.

The system under test is the port's `SlamSystem` in its production mode
(`async_mapping=True, pipelined=True`, as `run_slam.py` and the port's
`bench.py` legs run it), warmed up before the window. Inside the window the
session's frames are replayed through the sensor's `track_*` entry point
(`sensors.py`: `track_rgbd`, `track_stereo` or `track_monocular`), one
frame per call with the session's timestamps, the next frame submitted as
soon as the call returns: a closed loop with one client, as ORB-SLAM2's
dataset examples feed a recorded sequence. A traffic's `preroll` frames of
the first session are tracked the same way in set-up (the map that a
revisit needs), and the window goes on from there. At a session's end the harness
calls `flush()`, keeps the settled map, calls `reset()` (a new map) and
starts the next session; their time counts inside the window. It submits
nothing after the window's end.

A frame's latency runs from the start of the call that submitted it to the
moment its pose reaches a listener registered with `add_pose_listener`
(matched by session and timestamp): when a user of the pipelined system has
the pose. Frames published after the window's end count for the
correctness check, not for the metrics.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import sensors, stream, trace

MAP_FIELDS = ("kf_valid", "kf_pose", "kf_frame_id", "kf_xy", "kf_level", "kf_kp_valid", "kf_desc", "kf_mp",
              "mp_pos", "mp_valid")


@dataclasses.dataclass
class Window:
    seconds: float
    rate_hz: float
    session: int = 0
    t0: float = 0.0  # perf_counter at the window's start
    submitted: dict = dataclasses.field(default_factory=dict)  # (session, k) -> perf_counter
    published: dict = dataclasses.field(default_factory=dict)  # (session, k) -> (perf_counter, Tcw | None)
    frame_of_id: list = dataclasses.field(default_factory=list)  # per session: program frame id -> k
    maps: list = dataclasses.field(default_factory=list)  # per session: the map it left
    loops_at: list = dataclasses.field(default_factory=list)  # (session, k) where a closure was published
    n_loops_seen: int = 0

    def on_pose(self, sample: dict):
        key = (self.session, int(round(sample["timestamp"] * self.rate_hz)))
        if key not in self.published:
            tcw = sample["Tcw"]
            self.published[key] = (time.perf_counter(), None if tcw is None else np.array(tcw, np.float64))
        if sample["n_loops"] > self.n_loops_seen:
            self.n_loops_seen = sample["n_loops"]
            self.loops_at.append(key)

    def in_window(self):
        """(session, k) -> latency in seconds of the frames submitted and
        published in the window."""
        end = self.t0 + self.seconds
        return {key: t - self.submitted[key] for key, (t, _) in self.published.items()
                if t <= end and self.submitted.get(key, -1.0) >= self.t0}

    def first_pose(self) -> dict:
        """session -> the frame k of its first published pose; a session that
        published none is absent. A monocular session's frames before it are
        its two-view initializer's: the program publishes nothing for them."""
        first = {}
        for (s, k), (_, T) in self.published.items():
            if T is not None:
                first[s] = min(first.get(s, k), k)
        return first

    def attempted(self):
        """(session, k) of the frames submitted in the window."""
        return [key for key, t in self.submitted.items() if t >= self.t0]


def build_system(slam_cfg: dict, sensor: str, device):
    from orb_slam2v2_1_tpu_torch.models.system import Sensor, SlamSystem
    from orb_slam2v2_1_tpu_torch.utils.config import SlamConfig

    kind = Sensor[sensors.spec(sensor).member]
    return SlamSystem(config=SlamConfig(**slam_cfg), sensor=kind, async_mapping=True, pipelined=True,
                      device=device)


def snapshot(slam) -> dict:
    """The settled map's keyframes and points (the tensors themselves: the
    port's map updates are out of place)."""
    slam.get_pose_array()  # decides the frames in flight and adopts the workers' newest map
    return {f: getattr(slam.map, f) for f in MAP_FIELDS}


# Frames of one session between two gathers of the span ring: the ring keeps
# the spans of about a thousand frames (`spans.RING`).
GATHER_FRAMES = 256


class Stages:
    """The lengths in ms, by name, of the system's spans and counters
    (`"map"`, `"loop"`, `"frame_build"`, `"track_map_wait"`, ...) that ended
    in the window. They are gathered from the system's span ring, in which
    every span of `SlamSystem._metrics`' names also lands, at each session's
    end, every `GATHER_FRAMES` frames of a session and at the window's close:
    the per-name deques keep the last 128 mapping and loop rounds, fewer
    than a window holds. Made at the window's start."""

    def __init__(self, slam):
        self.names = list(slam._metrics)
        self.ring = slam._rec.ring
        self.t0 = time.perf_counter_ns()
        self.mark = None  # the newest record of the last gather
        self.got: dict[str, list] = {}
        self.lost = False

    def gather(self):
        """Take the records appended since the last gather. The ring is
        appended in order, so they are those after the last gather's newest;
        where that fell off the full ring, records may have been lost."""
        ring = list(self.ring)  # one atomic copy: the workers append
        new = []
        for r in reversed(ring):
            if r is self.mark:
                break
            new.append(r)
        else:
            full = len(ring) == self.ring.maxlen
            self.lost |= full and (self.mark is not None or ring[0][5] >= self.t0)
        for name, _, _, _, _, end_ns, ms in reversed(new):
            if end_ns >= self.t0:
                self.got.setdefault(name, []).append(ms)
        if ring:
            self.mark = ring[-1]

    def samples(self) -> dict:
        """name -> the window's samples ([] where none ended in it), or
        None for every name where the ring lost records between gathers."""
        names = self.names + [n for n in self.got if n not in self.names]
        return {n: None if self.lost else list(self.got.get(n, [])) for n in names}


def count(samples) -> str:
    return "full (not read)" if samples is None else str(len(samples))


def counters():
    from orb_slam2v2_1_tpu_torch import kernels, sync

    return {"reads": dict(sync.BY_ROLE), "launches": dict(kernels.LAUNCHES)}


def start(slam, rate_hz: float, seconds: float) -> Window:
    win = Window(seconds=seconds, rate_hz=rate_hz)
    win.frame_of_id.append({})
    slam.add_pose_listener(win.on_pose)
    return win


def _feed(win, slam, sess, sensor, k, span):
    n = len(sess.gt)
    spec = sensors.SENSORS[sensor]
    track = getattr(slam, spec.track)
    images = (sess.first[k % n],) if spec.second is None else (sess.first[k % n], sess.second[k % n])
    win.frame_of_id[-1][slam.frame_id] = k
    win.submitted[(win.session, k)] = time.perf_counter()
    with span("track"):
        track(*images, timestamp=float(sess.timestamps[k]))


def preroll(win: Window, slam, sess: stream.Session, sensor: str, frames: int):
    """Track frames [0, frames) of the first session (set-up)."""
    for k in range(frames):
        _feed(win, slam, sess, sensor, k, trace.no_span)


def drive(win: Window, slam, sess: stream.Session, sensor: str, tracer=None, first: int = 0, stages=None):
    """Replay sessions of `sess` through `slam` for the window's seconds, the
    first from frame `first`; `tracer` (a `trace.Stretch` or None) profiles
    its stretch of the first session; `stages` (a `Stages` or None) gathers
    the span ring at each session's end and every `GATHER_FRAMES` frames."""
    n = len(sess.timestamps)
    span = tracer.span if tracer is not None else trace.no_span
    win.t0 = time.perf_counter()
    end = win.t0 + win.seconds
    while True:
        for k in range(first, n):
            if time.perf_counter() >= end:
                break
            if tracer is not None:
                tracer.at_frame(win.session, k)
            _feed(win, slam, sess, sensor, k, span)
            if stages is not None and k % GATHER_FRAMES == GATHER_FRAMES - 1:
                stages.gather()
        else:
            with span("flush"):
                slam.flush()
                win.maps.append(snapshot(slam))
                if stages is not None:
                    stages.gather()
            with span("reset"):
                slam.reset()
            win.session += 1
            win.frame_of_id.append({})
            win.n_loops_seen = 0
            first = 0
            continue
        break
    if tracer is not None:
        tracer.stop()
    return win
