"""SLAM system facade: the host-side state machine of the online entry point.

Port of the JAX package's `models/system.py` for the monocular, RGB-D and
stereo sensors: the reference `System` + `Tracking` state machine
(src/System.cc:38-537, src/Tracking.cc:376-649). Each `track_monocular` /
`track_rgbd` / `track_stereo` call builds the frame, tracks it
(`frontend.track_frame_impl`), reads its decision vector, pose and relative
pose in one counted transfer, and then decides on the host: relocalization
on loss, the early-loss reset, the localization-mode visual odometry, the
keyframe policy and keyframe insertion. Before the first keyframe, a depth
sensor initializes from one frame and a monocular camera from two
(`ops.twoview.initialize_two_view`, seeded by the frame id).

Three modes, as in the reference:
- sync (`async_mapping=False`): the call inserts the keyframe with its local
  mapping round, then runs a loop-closing round with the global BA inline;
- async (`async_mapping=True`): the call only appends the keyframe; local
  mapping and loop closing run on the native runtime's worker threads
  (`runtime/pipeline.py`) on snapshots of a versioned `MapBox`, with the
  global BA detached on a thread of its own (the reference's LocalMapping,
  LoopClosing and GBA threads, src/System.cc:124-143);
- pipelined (`pipelined=True`, needs async): while tracking is healthy a
  frame's decision vector is copied to the host without waiting, and the
  decision for frame k is taken when its copy has arrived, at most
  `pipeline_depth` frames later; `track_*` then returns the frame's pose as
  a tensor on the device.

Spans (`spans.py`): each `track_*` call is a span `track` keyed by its
frame id, holding `settle` (the decisions of the frames in flight),
`frame_build`, `tracking` and `decide` (the decision of a frame tracked
without pipelining, or of an initializing frame), with `kf_insert` (a
keyframe's append and submit, keyed by its id) inside either; the call also
counts its waits in reads and on the map (`track_read_wait`,
`track_map_wait`). The workers' rounds are spans `map` (with `local_ba`)
and `loop`, keyed by the keyframe, and `map_queue` a keyframe's wait for its
round. Every name's lengths are kept in `_metrics`; `spans()` reads the ring.

A session can stream its keyframes to a map server (`connect_server`,
`parallel/stream.py`), load the server's map, merged with another session's
if asked (`fetch_server_map`), and adopt a map the server's operator pushed
(`poll_server_push`).

With `mesh` (a `parallel.mesh.Mesh`, a sequence of devices, or "auto" for
every visible card) of more than one shard, each keyframe's local BA window
and the loop closer's global BA, inline or detached, solve with their
observations sharded over the mesh (`parallel/dist_ba.py`): in sync mode the
keyframe is appended and its mapping round runs `mapping_pipeline_dist`, in
async mode the mapping worker does. A device may appear more than once
(`mesh=["cpu"] * 8`, `["cuda:0"] * 4`): virtual shards on one device.
"""

from __future__ import annotations

import enum
import io
import os
import time as _time
from collections import deque
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from .. import kernels, spans, sync
from ..ops import ba, lie, orb, prng, twoview
from ..ops import vocab as vocab_ops
from ..parallel import mesh as mesh_mod
from ..runtime import native
from ..runtime.pipeline import AsyncMapper, MapBox
from ..utils import serialization
from ..utils.config import SlamConfig
from ..utils.trajectory import Trajectory
from . import frontend, initialization, local_mapping, relocalization
from . import keyframe_database as kdb
from . import loop_closing as lc
from .loop_closing import LoopCloser
from .map_state import MapState, covisibility, empty_map, refresh_covis
from .tracking import FrameData

# The package's vocabulary (`data/vocab.npz`, package data): without the file
# a system has no vocabulary, so no relocalization and no loop closing.
VOCAB_NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "vocab.npz")

# Each span's or counter's name in `SlamSystem._metrics` and the samples its
# deque keeps: "track", "map" and "loop" as they always were; the names of a
# frame hold 4096 (a window of a minute at 60 frames/s and its warm-up), those
# of a keyframe 1024.
STAGES = (("track", 512), ("map", 128), ("loop", 128),
          ("settle", 4096), ("frame_build", 4096), ("tracking", 4096), ("decide", 4096),
          ("track_read_wait", 4096), ("track_map_wait", 4096),
          ("kf_insert", 1024), ("map_queue", 1024), ("local_ba", 1024))


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class _Pending(NamedTuple):
    """A dispatched but undecided frame on the pipelined path."""

    res: frontend.FrameResult  # tensors on the device
    stats: sync.AsyncRead  # the decision vector's copy to the host
    timestamp: float
    frame_id: int
    ref_kf: int  # the reference keyframe it was tracked against
    version: int  # the MapBox version it was tracked on


@dataclass
class SlamSystem:
    config: SlamConfig
    sensor: Sensor = Sensor.MONOCULAR
    # Local mapping and loop closing on worker threads (see the module doc).
    async_mapping: bool = False
    # Deferred per-frame decisions (needs async_mapping).
    pipelined: bool = False
    pipeline_depth: int = 4
    # Pipelining engages only while tracking is healthy: an established map
    # (>= 5 keyframes) and this many inliers, a margin over the 30 of the
    # OK test (src/Tracking.cc:1110-1113). The reference decides keyframes
    # with no lag; a lag of a few frames is taken only where it cannot cost
    # the track.
    pipeline_min_inliers: int = 60
    # Device mesh of the sharded local and global BA (see the module doc);
    # None: the single-device solves.
    mesh: object = None
    # Where the map and frames live; None means the card (raises without one).
    device: object = None

    state: TrackState = TrackState.NO_IMAGES_YET
    map: MapState = None
    trajectory: Trajectory = field(default_factory=Trajectory)

    # Tracking context
    last_frame: FrameData = None
    ref_kf: int = 0
    last_kf_frame: int = -1
    frame_id: int = 0
    n_kf_host: int = 0
    # Monocular: the first frame of the pair being initialized.
    init_ref: FrameData = None

    def __post_init__(self):
        if self.pipelined and not self.async_mapping:
            raise ValueError("pipelined=True requires async_mapping=True")
        # "auto": every visible card; one card or none means no mesh.
        self.mesh = mesh_mod.resolve(self.mesh)
        self.device = device_mod.resolve(self.device)
        c = self.config
        dev = self.device
        self.map = empty_map(c.max_keyframes, c.max_map_points, c.n_features, device=dev)
        self._K = torch.tensor(c.K, dtype=torch.float32, device=dev)
        self._dist = torch.tensor(c.dist, dtype=torch.float32, device=dev)
        self._bf = float(np.float32(c.bf))
        self._orb_cfg = orb.OrbConfig(
            n_features=c.n_features, n_levels=c.n_levels, scale=c.scale_factor,
            fast_threshold=c.fast_threshold, fast_min_threshold=c.fast_min_threshold,
        )
        self._min_frames = 0
        self._max_frames = int(c.fps)
        self._depth_limit = float(np.float32(c.bf * c.th_depth / c.fx)) if c.bf > 0 else 0.0
        self._velocity_dev = torch.eye(4, dtype=torch.float32, device=dev)
        self._have_velocity = False
        self._init_recognition()
        self._box = None
        self._mapper = None
        self._map_version = 0
        self._loops_seen = 0
        self._odom_Tcw = None
        self._last_Tcw = None
        # Keyframes the mapping worker erased, queued for the tracker's
        # trajectory bookkeeping (list.append and pop are atomic).
        self._pending_redirects = []
        self._vo_mode = False  # mbVO analog (src/Tracking.cc:434-501)
        self.n_resets = 0
        # Relocalizations that succeeded (a frame tracked after loss through
        # the reference keyframe is not one).
        self.n_relocalized = 0
        # Each frame declared lost: {"frame", "stats" (the decision vector),
        # "ref_kf", "n_kf", "relocalized_on" (keyframe or None)}.
        self.losses: list[dict] = []
        # False while the map came from outside (load_map, a server map):
        # the tracker's reference keyframe is then not where it lost track.
        self._reloc_join = True
        self._pose_listeners = []
        # Pipelined tracking.
        self._pending: deque[_Pending] = deque()
        self._odom_dev = None  # the odometry chain on the device
        self._odom_skip_next = False
        self._pipeline_healthy = False
        # EMA of the per-frame decay of the tracked-close count, to anticipate
        # the keyframe trigger by the decision lag (_need_new_keyframe_stats).
        self._close_decay = 0.0
        self._prev_close = None
        # Transient-dip grace budget: frames already in flight when a
        # keyframe trigger lands can dip below the 30-inlier OK bar before
        # the new keyframe reaches them; up to 2 consecutive such frames keep
        # their stage-2 pose instead of declaring loss (their >= 15 inliers
        # still pin it).
        self._grace_left = 0
        # Rolling per-stage latency (ms), see stats() and the module doc;
        # "map" and "loop" are timed inside the call in sync mode and on the
        # workers in async mode. The recorder and its deques outlive reset().
        self._rec = spans.Recorder()
        for name, n in STAGES:
            self._rec.keep(name, n)
        self._metrics = self._rec.series
        self._stream = None  # the map server connection, see connect_server
        self._sent_rows = self._sent_valid = None  # what the server holds of each keyframe row
        if self.async_mapping:
            self._start_async()

    def _init_recognition(self):
        """Vocabulary + keyframe database + loop closer (the System
        constructor loads the vocabulary and wires LoopClosing,
        src/System.cc:76-130)."""
        c = self.config
        if os.path.exists(VOCAB_NPZ):
            self.vocab = vocab_ops.load_vocabulary(np.load(VOCAB_NPZ), device=self.device)
            self.kf_db = kdb.empty_database(c.max_keyframes, c.n_features, self.vocab.n_words, device=self.device)
            self.loop_closer = LoopCloser(self.vocab, self.kf_db, fix_scale=self.sensor != Sensor.MONOCULAR,
                                          K=self._K, bf=self._bf, mesh=self.mesh)
        else:  # pragma: no cover — vocabulary file missing
            self.vocab = None
            self.kf_db = None
            self.loop_closer = None
        self.n_loops_closed = 0
        self.localization_only = False

    # ------------------------------------------------------------------
    # The async workers (LocalMapping / LoopClosing threads)
    # ------------------------------------------------------------------
    def _start_async(self):
        """Start the mapping and loop-closing workers on a box holding the
        current map (the System constructor's thread spawns,
        src/System.cc:124-143)."""
        self._box = MapBox(self.map)
        self._map_version = 0
        closer = self.loop_closer

        def mapping_fn(state, kf_id, allow_ba):
            with self._rec.span("map", kf_id):
                kf = torch.tensor(kf_id, dtype=torch.int64, device=self.device)
                if self.mesh is not None:
                    state, victim, vparent, T_red = frontend.mapping_pipeline_dist(
                        state, kf, self._K, self._bf, self.mesh, voc=self.vocab, allow_ba=allow_ba)
                else:
                    state, victim, vparent, T_red = frontend.mapping_pipeline(
                        state, kf, self._K, self._bf, allow_ba, voc=self.vocab)
                v, p, T = sync.host_numpy(victim, vparent, T_red)  # also ends the round for its timing
                if int(v) >= 0:
                    # The tracker rewrites its trajectory on its next frame.
                    self._pending_redirects.append((int(v), int(p), T))
            return state

        loop_fn = loop_service_fn = None
        if closer is not None:
            # The global BA runs detached from the loop worker's structural
            # lock: on its own thread in abortable chunks, merged when done
            # (the reference's GBA thread, src/LoopClosing.cc:588).
            closer.enable_detached_gba(ring=self._rec.ring)

            def loop_fn(snapshot, kf_id):
                # Detection on the snapshot, lock-free; returns the closure
                # (run under the structural lock) or None.
                with self._rec.span("loop", int(kf_id)):
                    trig = closer.detect_loop(snapshot, int(kf_id), self.n_kf_host)
                if trig is None:
                    return None
                cand, S12 = trig
                return lambda state: closer.apply_closure(state, int(kf_id), cand, S12)

            def loop_service_fn():
                closer.service_gba(self._box)

            def join_fn(snapshot, kf_before, kf_reloc):
                S12 = closer.detect_join(snapshot, kf_before, kf_reloc)
                if S12 is None:
                    return None
                return lambda state: closer.apply_closure(state, kf_before, kf_reloc, S12)

        self._mapper = AsyncMapper(self._box, mapping_fn, loop_fn=loop_fn, loop_service_fn=loop_service_fn,
                                   device=self.device, join_fn=join_fn if closer is not None else None,
                                   recorder=self._rec)

    def _stop_async(self, drain: bool):
        """Stop the workers (after their queues drain unless drain=False),
        let a detached global BA finish and fold in, and adopt the final
        map (System::Shutdown, src/System.cc:570-596)."""
        mapper, self._mapper = self._mapper, None
        try:
            mapper.shutdown(drain=drain)
        finally:
            if self.loop_closer is not None:
                self.loop_closer.finalize_gba(self._box)
            self.map, _ = self._box.read()
            self._box = None
            self.n_loops_closed = mapper.n_loops
            self._apply_redirects()

    def _refresh_from_box(self):
        if self._box is not None:
            self.map, self._map_version = self._box.read()

    def _apply_redirects(self):
        while self._pending_redirects:
            self._apply_cull(*self._pending_redirects.pop(0))

    def _publish_fresh_map(self):
        """Replace the box's content wholesale (initialization and map load
        build their map privately)."""
        if self._box is not None:
            self._box.publish(self.map)
            self._map_version = self._box.version

    def flush(self):
        """Decide every in-flight pipelined frame (blocking). Called by the
        shutdown, save and export methods."""
        if self._pending:
            self._drain_pending(force=True)

    def shutdown(self, drain: bool = True):
        """Decide the in-flight frames, stop the workers after draining their
        queues, finish a detached global BA and adopt the final map."""
        self.flush()
        try:
            if self._mapper is not None:
                self._stop_async(drain)
        finally:
            if self._stream is not None:
                stream, self._stream = self._stream, None
                stream.close()

    # ------------------------------------------------------------------
    # Multi-session server connection (StreamThread / ReceiveMapCallback)
    # ------------------------------------------------------------------
    def connect_server(self, host: str, port: int, client_id: int):
        """Stream this session's keyframes and points to a `MapServerNode`
        (the SendClassToServer hookup, src/System.cc:141-143)."""
        from ..parallel.stream import StreamClient

        self._stream = StreamClient(host, port, client_id)
        self._sent_rows = self._sent_valid = None

    def fetch_server_map(self, merge_with: int | None = None):
        """Load the server's map of this session, merged with session
        `merge_with`'s if given (the CLIENT_MAP<cid> / ReceiveMapCallback
        path, src/System.cc:1003-1066). Tracking then starts LOST and
        relocalizes in it."""
        self._adopt_map_bytes(self._stream.request_map(merge_with=merge_with))

    def poll_server_push(self) -> bool:
        """Adopt a map the server's operator pushed (Send,
        src/ServerViewer.cc:132-137), if there is one; returns whether a map
        was adopted. Called at keyframe cadence while connected."""
        if self._stream is None:
            return False
        payload = self._stream.poll_push()
        if payload is None:
            return False
        self._adopt_map_bytes(payload)
        return True

    def _adopt_map_bytes(self, payload: bytes):
        """Swap in a serialized map and start LOST, as `load_map` does; the
        BoW database is rebuilt from its keyframes."""
        self.flush()
        self._apply_redirects()
        restart = self._halt_workers()
        self.map, meta = serialization.load_map(io.BytesIO(payload), device=self.device)
        self.ref_kf = int(meta.get("ref_kf", 0))
        self.n_kf_host = int(meta.get("n_kf_host", sync.host(self.map.n_kf)))
        self.state = TrackState.LOST
        self._have_velocity = False
        self._last_Tcw = None
        self.last_frame = None
        self._reloc_join = False
        if self.vocab is not None:
            self.loop_closer.db = serialization.rebuild_database(self.map, self.vocab, self.config.max_keyframes,
                                                                 self.config.n_features)
        if restart:
            self._loops_seen = 0
            self._start_async()

    def _stream_keyframe(self):
        """Send the new keyframe and the refined poses to the map server
        (the Map::Add/UpdateKeyFrame forwarding, src/Map.cc:35-98), then take
        an operator's push if one waits (the poll stands in for the
        CLIENT_MAP<cid> subscription).

        The reference sends the new keyframe only. Its server then keeps
        every older keyframe's point associations as they were at insertion,
        while mapping fuses and culls points and hands the freed slots to new
        ones: an old row ends up naming other points, and a merge matches
        against them (on the desk sweep most of an early keyframe's points,
        1.7 m off at the median). So the port sends again, as INSERT deltas
        of the reference's format, every live keyframe whose associations
        changed since it was sent, and an ERASE for every sent keyframe
        culled since; the new keyframe is one of the changed ones."""
        if self._stream is None:
            return
        from ..parallel import server as delta_codec

        st = self.map
        if self._sent_rows is None:
            self._sent_rows = torch.full_like(st.kf_mp, -2)
            self._sent_valid = torch.zeros_like(st.kf_valid)
        changed = st.kf_valid & torch.any(st.kf_mp != self._sent_rows, dim=1)
        changed[self.ref_kf] |= st.kf_valid[self.ref_kf]
        erased = self._sent_valid & ~st.kf_valid
        changed, erased, valid = sync.host_numpy(changed, erased, st.kf_valid)
        for k in np.where(changed)[0]:
            self._stream.send_keyframe(st, int(k))
        for k in np.where(erased)[0]:
            self._stream.send_raw_delta(delta_codec.encode_keyframe_delta(st, int(k), delta_codec.ERASE))
        self._sent_rows = st.kf_mp.clone()
        self._sent_valid = st.kf_valid.clone()
        self._stream.send_pose_update(st, np.where(valid)[0])
        self.poll_server_push()

    # ------------------------------------------------------------------
    # Public per-frame entry points (System::TrackMonocular / TrackRGBD /
    # TrackStereo)
    # ------------------------------------------------------------------
    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def _call(self):
        """The span of one `track_*` call and its wait counters."""
        return self._rec.call("track", self.frame_id, "track_read_wait", "track_map_wait")

    def track_monocular(self, img, timestamp: float):
        with self._call():
            return self._step(img, None, timestamp)

    def track_rgbd(self, img, depth, timestamp: float):
        with self._call():
            return self._step(img, depth, timestamp)

    def track_stereo(self, img_left, img_right, timestamp: float):
        """Stereo entry point (System::TrackStereo, src/System.cc:365-423):
        the frame is built from the rectified pair, then tracked as an RGB-D
        frame (ur and depth from the disparity)."""
        with self._call():
            frame = frontend.build_frame_stereo(
                self._tensor(img_left), self._tensor(img_right), self._K, self._dist, self._bf,
                self.frame_id, self._orb_cfg,
            )
            return self._step_built(frame, timestamp)

    def _settle_pending(self):
        """Decide the in-flight frames whose statistics have arrived; if
        pipelining has stopped (health dropped, loss), decide them all, so
        the synchronous path sees settled state."""
        with self._rec.span("settle"):
            if self._pending:
                self._drain_pending()
                if self._pending and not self._pipelining_active():
                    self._drain_pending(force=True)

    def _step(self, img, depth, timestamp: float):
        self._settle_pending()
        c = self.config
        img_t = self._tensor(img)
        depth_t = None if depth is None else self._tensor(depth)
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            frame = frontend.build_frame_only(img_t, depth_t, self._K, self._dist, self._bf, self.frame_id,
                                              self._orb_cfg, c.width, c.height)
            return self._first_frame(frame, timestamp)
        if self.last_frame is None:
            # A loaded map has no previous frame: track this one against
            # itself, which falls through to relocalization.
            self.last_frame = frontend.build_frame_only(img_t, depth_t, self._K, self._dist, self._bf,
                                                        self.frame_id, self._orb_cfg, c.width, c.height)
        self._refresh_from_box()
        res = frontend.process_frame_impl(
            self.map, img_t, depth_t, self.last_frame, self._velocity_dev, self._have_velocity, self.ref_kf,
            self._K, self._dist, self._bf, self._depth_limit, self.frame_id, self._orb_cfg, c.width, c.height,
            self.vocab, vo_points=self._vo_points_enabled(), mono=self.sensor == Sensor.MONOCULAR,
        )
        if self._pipelining_active():
            return self._enqueue_pending(res, timestamp)
        return self._handle_result(res, timestamp)

    def _step_built(self, frame: FrameData, timestamp: float):
        """Shared tracking for a frame built by the caller (stereo path)."""
        self._settle_pending()
        c = self.config
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            return self._first_frame(frame, timestamp)
        if self.last_frame is None:
            self.last_frame = frame
        self._refresh_from_box()
        res = frontend.track_frame_impl(
            self.map, frame, self.last_frame, self._velocity_dev, self._have_velocity, self.ref_kf, self._K,
            self._bf, self._depth_limit, c.width, c.height, self.vocab, vo_points=self._vo_points_enabled(),
        )
        if self._pipelining_active():
            return self._enqueue_pending(res, timestamp)
        return self._handle_result(res, timestamp)

    def _first_frame(self, frame: FrameData, timestamp: float):
        """A frame before initialization: bootstrap the map from it if it
        has enough keypoints."""
        with self._rec.span("decide"):
            self.state = TrackState.NOT_INITIALIZED
            ok = self._initialize(frame)
            self.frame_id += 1
            if not ok:
                return None
            self._publish_fresh_map()
            self.state = TrackState.OK
            self._velocity_dev = torch.eye(4, dtype=torch.float32, device=self.device)
            self._have_velocity = False
            out = self._record(timestamp, self.last_frame.pose)
            self._publish_pose(timestamp, out)
            return out

    def _vo_points_enabled(self) -> bool:
        """Temporal VO points (mbVO, src/Tracking.cc:434-501): localization
        mode on a depth-capable sensor."""
        return self.localization_only and self.sensor != Sensor.MONOCULAR

    # ------------------------------------------------------------------
    # Pipelined tracking: deferred decisions
    # ------------------------------------------------------------------
    def _pipelining_active(self) -> bool:
        return (self.pipelined and self._box is not None and self.state == TrackState.OK
                and not self.localization_only and self._pipeline_healthy)

    def _update_health(self, tracked_ok: bool, stats):
        self._pipeline_healthy = bool(tracked_ok) and stats[1] >= self.pipeline_min_inliers and self.n_kf_host >= 5

    def _enqueue_pending(self, res: frontend.FrameResult, timestamp: float):
        """Dispatch bookkeeping of a pipelined frame: start the copy of its
        statistics, chain the tracking context on the device, defer every
        decision."""
        self._pending.append(_Pending(res, sync.AsyncRead(res.stats), timestamp, self.frame_id, self.ref_kf,
                                      self._map_version))
        self.last_frame = res.frame
        self._velocity_dev = res.velocity
        self._have_velocity = True
        self.frame_id += 1
        return res.pose

    def _drain_pending(self, force: bool = False):
        """Decide the dispatched frames whose statistics have arrived; wait
        only when the window is over `pipeline_depth` (or force=True)."""
        while self._pending:
            must = force or len(self._pending) > self.pipeline_depth
            if not must and not self._pending[0].stats.is_ready():
                break
            e = self._pending.popleft()
            if not self._process_pending(e):
                # Loss or reset: every later frame in flight was tracked on a
                # broken chain; record them lost.
                for later in self._pending:
                    self.trajectory.append_rel(later.timestamp, later.ref_kf, np.eye(4), lost=True)
                    self._publish_pose(later.timestamp, None)
                self._pending.clear()
                break

    def _advance_odom_dev(self, e: _Pending):
        """One step of the device-side odometry chain (no host read)."""
        if self._odom_dev is None and self._odom_Tcw is not None:
            self._odom_dev = torch.as_tensor(self._odom_Tcw, dtype=torch.float32).to(self.device)
        if self._odom_dev is None:
            self._odom_dev = e.res.pose
        elif self._odom_skip_next:
            self._odom_skip_next = False
        else:
            self._odom_dev = _odom_step(self._odom_dev, e.res.velocity)

    def _process_pending(self, e: _Pending) -> bool:
        """The deferred decision half of a frame (the sync path's
        `_handle_result_impl` less what was chained at dispatch). Returns
        False when the window must be flushed (loss or reset)."""
        stats = e.stats.numpy()
        self._apply_redirects()
        # Advisory visibility statistics: published only if nothing (our own
        # later publishes included) landed since the frame was dispatched.
        self._box.publish(e.res.state, expected_version=e.version)
        self.map, self._map_version = self._box.read()
        if self._mapper.n_loops != self._loops_seen:
            # A loop closed in the background: frames in flight straddle the
            # jump; drop the motion model and keep the jump out of the
            # odometry chain.
            self._loops_seen = self.n_loops_closed = self._mapper.n_loops
            self._have_velocity = False
            self._odom_skip_next = True
        self._mapper.raise_worker_errors()

        tracked_ok = stats[0] > 0
        self._update_health(tracked_ok, stats)
        if tracked_ok:
            if self._prev_close is not None:
                self._close_decay = 0.7 * self._close_decay + 0.3 * max(0.0, self._prev_close - float(stats[4]))
            self._prev_close = float(stats[4])
        else:
            self._prev_close = None
        if tracked_ok:
            self._grace_left = 2
        elif stats[1] >= 15 and self._grace_left > 0:
            # Transient dip: keep the stage-2 pose (see _grace_left).
            self._grace_left -= 1
            self.trajectory.append_rel(e.timestamp, e.ref_kf, e.res.T_rel)
            self._advance_odom_dev(e)
            self._publish_pose(e.timestamp, e.res.pose)
            return True
        if not tracked_ok:
            self.trajectory.append_rel(e.timestamp, e.ref_kf, np.eye(4), lost=True)
            self._publish_pose(e.timestamp, None)
            self._log_loss(e.frame_id, stats)
            # The sync loss policy: relocalize on this frame's features at
            # once, else the early reset or LOST.
            if self.loop_closer is not None:
                ok_r, Tcw_r, frame_mp, ref = self._relocalize(e.res.frame, e.frame_id)
                if ok_r:
                    before = self.ref_kf
                    self.ref_kf = ref
                    self.last_frame = e.res.frame._replace(pose=Tcw_r, mp=frame_mp)
                    self._have_velocity = False
                    self._odom_skip_next = True
                    self._record(e.timestamp, Tcw_r)
                    self._join_after_relocalization(before, ref)
                    return False  # flush the frames in flight; the chain is re-anchored
            self._sync_odom_from_device()
            if self.n_kf_host <= 5:
                self.reset()
            else:
                self.state = TrackState.LOST
                self._have_velocity = False
                self._last_Tcw = None
            return False

        self.trajectory.append_rel(e.timestamp, e.ref_kf, e.res.T_rel)
        self._advance_odom_dev(e)
        self._publish_pose(e.timestamp, e.res.pose)
        if self._need_new_keyframe_stats(stats, frame_id=e.frame_id, lag=len(self._pending) + 1):
            # Insert the newest tracked frame, not the decided one: the
            # reference's CreateNewKeyFrame uses mCurrentFrame
            # (src/Tracking.cc:1206); under the decision lag the newest view
            # is what the map must cover to feed the next frames. But only a
            # frame known to be tracked: an in-flight frame whose tracking
            # failed has no map-point associations and a doubtful pose, and as
            # a keyframe it starts a part of the map joined to nothing, on
            # which the next frames lose track or drift off (the reference
            # inserts it all the same). So the newest frame's decision vector
            # is read, waiting for it if it has not arrived, and the decided
            # frame is inserted when the newest was not tracked.
            newest = self._pending[-1] if self._pending else e
            if newest is not e and not newest.stats.numpy()[0] > 0:
                newest = e
            self._insert_keyframe_async(newest.res, newest.ref_kf)
        return True

    # ------------------------------------------------------------------
    # The per-frame decision
    # ------------------------------------------------------------------
    def _handle_result(self, res: frontend.FrameResult, timestamp: float):
        with self._rec.span("decide"):
            out = self._handle_result_impl(res, timestamp)
            self._publish_pose(timestamp, out)
            return out

    def _relocalize(self, frame: FrameData, frame_id: int | None = None):
        out = relocalization.relocalize(self.map, self.loop_closer.db, self.vocab, frame, self._K, self._bf,
                                        self.frame_id if frame_id is None else frame_id)
        self.n_relocalized += int(out[0])
        if out[0] and self.losses and self.losses[-1]["relocalized_on"] is None:
            self.losses[-1]["relocalized_on"] = int(out[3])
        return out

    def _log_loss(self, frame_id: int, stats):
        self.losses.append({"frame": int(frame_id), "stats": [float(x) for x in stats], "ref_kf": self.ref_kf,
                            "n_kf": self.n_kf_host, "relocalized_on": None})

    def _join_after_relocalization(self, kf_before: int, kf_reloc: int) -> bool:
        """A relocalization onto a keyframe that shares no map point with
        the keyframe tracking was lost from has joined two parts of the map
        that no loop closure joined: on a revisit, the drifted second pass
        and the first. Tracking then follows the first pass and builds
        keyframes covisible with it, so loop detection, which skips
        covisible candidates, never closes that loop, and the drift of the
        second pass before the loss stays in the map and the trajectory.
        The port closes it here: the two keyframes go to the loop closer as
        a candidate pair (Sim3, then the correction and fusion of a loop).
        The reference does not (its relocalization touches no map); this
        departs from it on purpose. Returns whether a closure was made (sync
        mode) or queued for the loop worker (async)."""
        if not self._reloc_join or self.localization_only or self.loop_closer is None or kf_before == kf_reloc:
            self._reloc_join = True
            return False
        if self._box is not None:
            self._mapper.submit_join(kf_before, kf_reloc)
            return True
        S12 = self.loop_closer.detect_join(self.map, kf_before, kf_reloc)
        if S12 is None:
            return False
        self.map = self.loop_closer.apply_closure(self.map, kf_before, kf_reloc, S12)
        self.n_loops_closed += 1
        self._have_velocity = False
        self._last_Tcw = None
        return True

    def _accept_relocalization(self, res, timestamp, Tcw_r, frame_mp, ref):
        before = self.ref_kf
        self.state = TrackState.OK
        self.ref_kf = ref
        self.last_frame = res.frame._replace(pose=Tcw_r, mp=frame_mp)
        self._have_velocity = False
        # The relocalized pose is discontinuous with the pre-loss pose: the
        # first frame after it must not apply a difference to the odometry
        # chain (src/Tracking.cc:548).
        self._last_Tcw = None
        self.frame_id += 1
        out = self._record(timestamp, Tcw_r)
        self._update_odom(out)
        self._join_after_relocalization(before, ref)
        return out

    def _handle_result_impl(self, res: frontend.FrameResult, timestamp: float):
        # The single per-frame read: every host-needed output in one transfer.
        stats, pose_np, T_rel_np = sync.host_numpy(res.stats, res.pose, res.T_rel)
        self._apply_redirects()
        if self._box is not None:
            # Advisory: the visibility statistics lose the race against a
            # structural (mapping or loop) update; the next frame reads the box.
            self._box.publish(res.state, expected_version=self._map_version)
            self.map, self._map_version = self._box.read()
            if self._mapper.n_loops != self._loops_seen:
                # A loop closed in the background: the map moved under the
                # motion model (CorrectLoop's map-update mutex analog).
                self._loops_seen = self.n_loops_closed = self._mapper.n_loops
                self._have_velocity = False
                self._last_Tcw = None  # the odometry chain must not absorb the jump
            self._mapper.raise_worker_errors()
        else:
            self.map = res.state
        tracked_ok = stats[0] > 0
        self._update_health(tracked_ok, stats)

        # mbVO localization fallback (src/Tracking.cc:434-501): in
        # localization-only mode, when the local map no longer supports the
        # pose but frame-to-frame odometry does, keep the odometry pose and
        # try to re-anchor by relocalization every frame.
        if self.localization_only and not tracked_ok and stats[8] >= 20:
            self._vo_mode = True
            if self.loop_closer is not None:
                ok_r, Tcw_r, frame_mp, ref = self._relocalize(res.frame)
                if ok_r:
                    self._vo_mode = False
                    return self._accept_relocalization(res, timestamp, Tcw_r, frame_mp, ref)
            self.state = TrackState.OK
            self._velocity_dev = res.velocity
            self._have_velocity = True
            self.last_frame = res.frame
            self.trajectory.append_rel(timestamp, self.ref_kf, T_rel_np)
            self._update_odom(pose_np)
            self.frame_id += 1
            return pose_np
        if tracked_ok:
            self._vo_mode = False

        if not tracked_ok:
            if self.state == TrackState.OK:
                self._log_loss(self.frame_id, stats)
            # Relocalization attempt (Tracking::Relocalization on LOST,
            # src/Tracking.cc:429,1486).
            if self.loop_closer is not None:
                ok_r, Tcw_r, frame_mp, ref = self._relocalize(res.frame)
                if ok_r:
                    return self._accept_relocalization(res, timestamp, Tcw_r, frame_mp, ref)
            # Early-loss auto-reset (src/Tracking.cc:614-622): losing track
            # right after initialization means the young map is bad.
            if not self.localization_only and self.n_kf_host <= 5 and self.state == TrackState.OK:
                self.reset()
                return None
            self.state = TrackState.LOST
            self._have_velocity = False
            self._last_Tcw = None  # the odometry chain must not bridge the gap
            self.frame_id += 1
            self.trajectory.append_rel(timestamp, self.ref_kf, np.eye(4), lost=True)
            return None

        self.state = TrackState.OK
        self._velocity_dev = res.velocity
        self._have_velocity = True
        self.trajectory.append_rel(timestamp, self.ref_kf, T_rel_np)
        self.last_frame = res.frame
        self._update_odom(pose_np)

        if not self.localization_only and self._need_new_keyframe_stats(stats):
            if self.async_mapping:
                self._insert_keyframe_async(res, self.ref_kf)
                self.last_frame = res.frame._replace(pose=self.map.kf_pose[self.ref_kf],
                                                     mp=self.map.kf_mp[self.ref_kf])
            else:
                self._insert_keyframe_fused(res.frame)
                # Mapping (cull/fuse) may have merged or killed points: re-read
                # this frame's associations from its own keyframe row.
                self.last_frame = res.frame._replace(mp=self.map.kf_mp[self.ref_kf])
                if self.loop_closer is not None:
                    with self._rec.span("loop", self.ref_kf):
                        self.map, closed = self.loop_closer.on_keyframe(self.map, self.ref_kf, self.n_kf_host)
                    if closed:
                        self.n_loops_closed += 1
                        # The map moved under the motion model.
                        self._have_velocity = False
                        self._last_Tcw = None
        self.frame_id += 1
        return pose_np

    # ------------------------------------------------------------------
    # Live pose publication (ROS TF/Odometry/PoseArray analog,
    # src/ros_rgbd.cc:140-198,444-513).
    def add_pose_listener(self, fn):
        """Register fn(sample: dict), called after every processed frame with
        {"timestamp", "Tcw" (4,4) | None, "odom" (4,4) | None,
        "state": TrackState, "n_kf", "n_loops"}."""
        self._pose_listeners.append(fn)

    def _publish_pose(self, timestamp, Tcw):
        if not self._pose_listeners:
            return
        if isinstance(Tcw, torch.Tensor):
            (Tcw,) = sync.host_numpy(Tcw)
        sample = {
            "timestamp": timestamp,
            "Tcw": None if Tcw is None else np.asarray(Tcw),
            "odom": self.odom_pose,
            "state": self.state,
            "n_kf": self.n_kf_host,
            "n_loops": self.n_loops_closed,
        }
        for fn in self._pose_listeners:
            fn(sample)

    def spans(self, since_ns: int | None = None) -> list[spans.Span]:
        """The recorded spans and counters, oldest first: every span of the
        tracker and the workers (`spans.Span`: name, role, key, parent,
        start and end in `time.perf_counter_ns()`, ms); with `since_ns`,
        those that ended at or after it. Kept across `reset()`."""
        return self._rec.spans(since_ns)

    def stats(self) -> dict:
        """Rolling runtime/health snapshot with the reference's keys:
        per-stage latency percentiles (ms), map/loop counters, the track
        state and the frames in flight. No device read."""

        def pct(xs, q):
            xs = list(xs)  # one atomic copy: the workers append to "map" and "loop"
            return float(np.percentile(np.asarray(xs), q)) if xs else None

        runner = self.loop_closer.gba_runner if self.loop_closer is not None else None
        gba = list(runner.solve_ms) if runner is not None else []
        return {
            "state": self.state.name,
            "track_ms_p50": pct(self._metrics["track"], 50),
            "track_ms_p90": pct(self._metrics["track"], 90),
            "map_ms_p50": pct(self._metrics["map"], 50),
            "loop_ms_p50": pct(self._metrics["loop"], 50),
            "gba_ms_last": gba[-1] if gba else None,
            "n_kf": self.n_kf_host,
            "n_loops": self.n_loops_closed,
            "n_frames": self.frame_id,
            "n_resets": self.n_resets,
            "in_flight": len(self._pending),
            "ba_skipped": self._mapper.n_ba_skipped if self._mapper is not None else 0,
        }

    # ------------------------------------------------------------------
    def warmup(self, gba_buckets=(16, 32, 64), fuse_buckets=((16, 4096),), verbose: bool = False):
        """Pay every lazy first-use cost of an online run before frame 0.

        The port has no JIT; what a first frame would otherwise pay is the
        build of the CUDA kernels and of the native runtime, the library
        handles (cuBLAS, cuSOLVER) and the allocator's first pools. So this
        builds both, then runs each program an online run can reach once on
        inputs of the production shapes (a noise image with unit depth) on
        maps of its own: the sensor's frame build, tracking, initialization,
        keyframe append and the mapping round at both `allow_ba` values, the
        forced keyframe cull, a loop round's database, Sim3, correction and
        fusion steps (`fuse_buckets`: the (fuse_kfs, mp_cap) rungs), the
        global-BA chunks at the `gba_buckets` live-keyframe sizes up to
        `max_keyframes`, relocalization and the odometry step. The system's
        own state (map, trajectory, frame id, tracking state, database, loop
        closer) is left as it was."""
        c = self.config
        dev = self.device
        if dev.type == "cuda":
            kernels.build()
        native.load()
        K, bf = self._K, self._bf
        mono = self.sensor == Sensor.MONOCULAR
        depth_limit = 0.0 if mono else self._depth_limit
        gen = torch.Generator(device=dev).manual_seed(0)
        img = torch.rand((c.height, c.width), generator=gen, device=dev) * 255.0
        depth = None if self.sensor != Sensor.RGBD else torch.ones((c.height, c.width), device=dev)
        img_right = torch.roll(img, -16, dims=1)  # a disparity of 16 px
        eye = torch.eye(4, dtype=torch.float32, device=dev)

        def fresh():
            return empty_map(c.max_keyframes, c.max_map_points, c.n_features, device=dev)

        def frame_dummy():
            if self.sensor == Sensor.STEREO:
                return frontend.build_frame_stereo(img, img_right, K, self._dist, bf, 0, self._orb_cfg)
            return frontend.build_frame_only(img, depth, K, self._dist, bf, 0, self._orb_cfg, c.width, c.height)

        frame = frame_dummy()
        if mono:
            # A map of one keyframe at unit depth, as the depth sensors' init
            # would build it.
            frame_init = frame._replace(depth=torch.where(frame.kp_valid, 1.0, -1.0))
        else:
            frame_init = frame
        s0, _, _ = initialization.create_initial_map_depth(fresh(), frame_init, K)
        steps = [
            ("frame build", frame_dummy),
            ("tracking", lambda: frontend.track_frame_impl(
                s0, frame, frame._replace(mp=s0.kf_mp[0]), eye, True, 0, K, bf, depth_limit, c.width, c.height,
                self.vocab, mono=mono)),
            ("append keyframe", lambda: frontend.append_keyframe_only(s0, frame, K, bf, depth_limit)),
        ]
        s1, kf1 = frontend.append_keyframe_only(s0, frame._replace(mp=s0.kf_mp[0]), K, bf, depth_limit)
        for allow_ba in (True, False):
            steps.append((f"mapping round (allow_ba={allow_ba})",
                          lambda allow_ba=allow_ba: frontend.mapping_pipeline(s1, kf1, K, bf, allow_ba,
                                                                              voc=self.vocab)))
        steps.append(("forced keyframe cull", lambda: local_mapping.cull_keyframes(s1, 1, force=True)))
        if self.vocab is not None:
            db = kdb.empty_database(c.max_keyframes, c.n_features, self.vocab.n_words, device=dev)
            steps += [
                ("database add", lambda: kdb.add_keyframe_from_state(db, self.vocab, s1, 0)),
                ("database add and detect", lambda: kdb.add_and_detect(db, self.vocab, s1, 1)),
                ("sim3", lambda: lc.compute_sim3(s1, 1, 0, K, prng.key(0), fix_scale=not mono, voc=self.vocab)),
                ("loop correction", lambda: lc.correct_loop(s1, 1, 0, eye)),
                ("fuse sizes", lambda: sync.host(torch.stack(lc._fuse_sizes(s1, 1, 0)))),
            ]
            for fk, mc in fuse_buckets:
                steps.append((f"loop fusion ({fk}, {mc})",
                              lambda fk=fk, mc=mc: lc.search_and_fuse(s1, 1, 0, K, fuse_kfs=fk, mp_cap=mc)))
            steps.append(("covisibility refresh", lambda: refresh_covis(s1)))
            runner = self.loop_closer.gba_runner or lc.GlobalBARunner(K, bf)

            def warm_gba(kb):
                prob, slots, used = lc.build_global_ba_problem_compact(s1, K, bf, kb)
                dense = prob.poses.shape[0] <= runner.dense_max_cams
                for robust in (True, False):
                    out = ba.ba_step_count_lam(prob, 1e-4, iters=runner.chunk_iters, cg_iters=runner.cg_iters,
                                               robust=robust, dense=dense)
                    sync.host(out[3])
                prob2 = ba.classify_outliers(prob)
                poses, fixed = lc.expand_gba_result(s1.kf_pose, prob2.poses, prob2.cam_fixed, slots, used)
                return lc.merge_gba_into_live(s1, s1.kf_seq, s1.kf_valid, s1.mp_first_seq, s1.mp_valid, poses,
                                              prob2.points, fixed)

            for kb in gba_buckets:
                if kb <= c.max_keyframes:
                    steps.append((f"global BA chunks (kb={kb})", lambda kb=kb: warm_gba(kb)))
            db1 = kdb.add_keyframe_from_state(db, self.vocab, s1, 0)
            steps.append(("relocalization", lambda: relocalization.relocalize(s1, db1, self.vocab, frame, K, bf, 0)))
        steps.append(("odometry step", lambda: _odom_step(eye, eye)))

        for name, thunk in steps:
            t0 = _time.perf_counter()
            thunk()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if verbose:
                print(f"warmup {name}: {_time.perf_counter() - t0:.2f} s", flush=True)

    def activate_localization_mode(self):
        """Tracking-only mode: no new keyframes or map mutation
        (System::ActivateLocalizationMode, src/System.cc:539-547)."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def _halt_workers(self) -> bool:
        """Stop the async workers without draining their queues and abort a
        detached global BA; returns whether workers were running."""
        running = self._mapper is not None
        if running:
            self._mapper.shutdown(drain=False)
            self._mapper = None
            self._box = None
        if self.loop_closer is not None and self.loop_closer.gba_runner is not None:
            self.loop_closer.gba_runner.abort()
            self.loop_closer.gba_runner.join()
        return running

    def reset(self):
        """Clear the map and restart (System::Reset -> Tracking::Reset,
        src/Tracking.cc:1650-1698); in async mode the workers are stopped
        without draining and started again on the empty map."""
        restart = self._halt_workers()
        c = self.config
        self.map = empty_map(c.max_keyframes, c.max_map_points, c.n_features, device=self.device)
        self.state = TrackState.NO_IMAGES_YET
        self.last_frame = None
        self.init_ref = None
        self.ref_kf = 0
        self.n_kf_host = 0
        self.last_kf_frame = -1
        self._have_velocity = False
        self._last_Tcw = None
        self._pending_redirects = []
        self._pending.clear()
        self._odom_dev = None
        self._odom_skip_next = False
        self._vo_mode = False
        self.n_resets += 1
        self.trajectory = Trajectory()
        self._init_recognition()
        self._loops_seen = 0
        if restart:
            self._start_async()

    def _need_new_keyframe_stats(self, stats, frame_id: int | None = None, lag: int = 0) -> bool:
        """NeedNewKeyFrame on the decision vector (the thresholds of
        src/Tracking.cc:1120-1204): monocular wants 90% of the reference
        keyframe's points and has no close-point trigger. `frame_id`
        defaults to the current frame (sync path); the pipelined path passes
        the decided frame's id and the decision `lag` (frames dispatched
        since it). The close-point trigger is anticipated by lag x the
        measured per-frame decay of the tracked-close count: by the time a
        lagged decision lands, the view has moved `lag` frames further."""
        n_inliers = stats[1]
        ref_matches = stats[3]
        frames_since = (self.frame_id if frame_id is None else frame_id) - self.last_kf_frame
        mono = self.sensor == Sensor.MONOCULAR
        c1a = frames_since >= self._max_frames
        c1b = frames_since >= max(self._min_frames, 1)
        c2 = (n_inliers < ref_matches * (0.9 if mono else 0.75)) and n_inliers > 15
        anticipate = lag * self._close_decay
        need_close = not mono and self.config.bf > 0 and stats[4] - anticipate < 100 and stats[5] > 70
        need = (c1b and (c2 or need_close)) or c1a
        if need and self.n_kf_host >= self.config.max_keyframes - 2:
            # Cull-on-full: erase one redundant keyframe so the map keeps
            # adapting on revisits; the freed slot serves the next insertion.
            self._cull_one()
            return False
        return need

    def _cull_one(self):
        """One KeyFrameCulling round outside the insertion (bounded-memory
        analog of src/LocalMapping.cc:640-704 on a full map)."""
        if self._box is not None:
            cell = []

            def step(state):
                state, victim, vparent, T_red = local_mapping.cull_keyframes(state, self.ref_kf, force=True)
                cell.extend(sync.host_numpy(victim, vparent, T_red))
                return state

            self.map = self._box.mutate(step)
            self._map_version = self._box.version
            v, p, T = cell
        else:
            self.map, victim, vparent, T_red = local_mapping.cull_keyframes(self.map, self.ref_kf, force=True)
            v, p, T = sync.host_numpy(victim, vparent, T_red)
        self._apply_cull(int(v), int(p), T)

    def _insert_keyframe_fused(self, frame: FrameData):
        with self._rec.span("map"):
            depth_limit = 0.0 if self.sensor == Sensor.MONOCULAR else self._depth_limit
            if self.mesh is not None:
                # The window BA sharded over the mesh: append, then the mapping
                # round with its solve on the mesh.
                self.map, kf_id = frontend.append_keyframe_only(self.map, frame, self._K, self._bf, depth_limit)
                self.map, victim, vparent, T_redirect = frontend.mapping_pipeline_dist(
                    self.map, kf_id, self._K, self._bf, self.mesh, voc=self.vocab)
            else:
                self.map, kf_id, _, victim, vparent, T_redirect = frontend.insert_keyframe_fused_impl(
                    self.map, frame, self._K, self._bf, depth_limit, self.vocab,
                )
            kf, v, p, T = sync.host_numpy(kf_id, victim, vparent, T_redirect)
        self.ref_kf = int(kf)
        self.n_kf_host += 1
        self.last_kf_frame = self.frame_id
        self._apply_cull(int(v), int(p), T)
        self._stream_keyframe()

    def _insert_keyframe_async(self, res: frontend.FrameResult, ref_kf: int):
        """Tracking-side keyframe creation: the structural append, then the
        mapping round handed to the worker (CreateNewKeyFrame +
        LocalMapping::InsertKeyFrame, src/Tracking.cc:1206-1286).

        The frame was tracked on a snapshot. If its reference keyframe has
        moved in the live map since (a loop correction, a global-BA merge, a
        local BA), the keyframe is placed by the frame's pose relative to
        that keyframe, `res.T_rel`, as the trajectory places the frame. The
        reference appends the snapshot's pose, which after a loop correction
        leaves the keyframe and its depth points where the map was before
        the correction, and the frames tracked on them follow it there.

        The frame's map-point associations are slot ids of the snapshot. A
        point killed in the live map since (merged by a loop fusion, culled
        by a mapping round) frees its slot, and the next allocation reuses it:
        this keyframe's own depth points, appended just after, take the
        lowest free slots. The reference appends the snapshot's ids as they
        are, and a keypoint then names another keypoint's new point: a false
        observation for the next local BA. Here an association is kept only
        if its slot holds the same live point as in the snapshot (valid in
        both, same creating keyframe); the others go, and the keypoint may
        get a depth point of its own, as ORB-SLAM2 gives one to a keypoint
        whose point went bad (`_live_associations`)."""
        depth_limit = 0.0 if self.sensor == Sensor.MONOCULAR else self._depth_limit
        snap_ref_pose, snap_ref_seq = res.state.kf_pose[ref_kf], res.state.kf_seq[ref_kf]
        cell = []

        def step(state):
            live_ref_pose = state.kf_pose[ref_kf]
            moved = (state.kf_valid[ref_kf] & (state.kf_seq[ref_kf] == snap_ref_seq)
                     & torch.any(live_ref_pose != snap_ref_pose))
            frame = res.frame._replace(pose=torch.where(moved, res.T_rel @ live_ref_pose, res.frame.pose),
                                       mp=_live_associations(res.frame.mp, res.state, state))
            state, kf_id = frontend.append_keyframe_only(state, frame, self._K, self._bf, depth_limit)
            cell.append(kf_id)
            return state

        with self._rec.span("kf_insert") as s:
            self.map = self._box.mutate(step)
            self._map_version = self._box.version
            self.ref_kf = s.key = int(sync.host(cell[0]))
            self.n_kf_host += 1
            self.last_kf_frame = self.frame_id
            self._mapper.submit_keyframe(self.ref_kf)
            self._stream_keyframe()

    def _apply_cull(self, victim: int, parent: int, T_redirect):
        """Host bookkeeping for an erased keyframe: rewrite trajectory
        references onto its spanning-tree parent and release the slot from
        the live count (src/KeyFrame.cc:432-546, src/System.cc:610-629)."""
        if victim < 0:
            return
        self.trajectory.redirect_kf(victim, parent, T_redirect)
        self.n_kf_host -= 1

    def _initialize(self, frame: FrameData) -> bool:
        """Depth sensors: every keypoint with depth of the first frame with
        >= 500 keypoints becomes a map point (StereoInitialization).
        Monocular: two frames, see `_initialize_mono`."""
        if self.sensor == Sensor.MONOCULAR:
            return self._initialize_mono(frame)
        if sync.host(torch.sum(frame.kp_valid)) < 500:
            return False
        self.map, kf0, _ = initialization.create_initial_map_depth(self.map, frame, self._K)
        self.ref_kf = int(sync.host(kf0))
        self.last_frame = frame._replace(mp=self.map.kf_mp[self.ref_kf])
        self.n_kf_host = 1
        self.last_kf_frame = self.frame_id
        return True

    def _initialize_mono(self, frame: FrameData) -> bool:
        """MonocularInitialization (src/Tracking.cc:706-760): a reference
        frame with > 100 keypoints, then the first later frame with >= 70
        matches to it (the reference wants 100; the two-view parallax gate
        rejects the short baselines) whose two-view reconstruction succeeds.
        The two-keyframe map is refined by a joint BA and rescaled to unit
        median depth."""

        def enough_keypoints():
            return sync.host(torch.sum(frame.kp_valid)) > 100

        if self.init_ref is None:
            if enough_keypoints():
                self.init_ref = frame
            return False
        m = initialization.match_for_initialization(self.init_ref, frame)
        if sync.host(torch.sum(m.ok)) < 70:
            self.init_ref = frame if enough_keypoints() else None
            return False
        res = twoview.initialize_two_view(self.init_ref.xy, frame.xy[m.idx], m.ok, self._K,
                                          key=prng.key(self.frame_id))
        if not sync.host(res.success):
            return False
        self.map, _, _, _, _ = initialization.create_initial_map_mono(self.map, self.init_ref, frame, m.idx, res,
                                                                      self._K)
        # Joint BA over the two keyframes, then the gauge again (the
        # reference's GlobalBundleAdjustemnt(20) and median-depth rescale).
        one = torch.tensor(1, dtype=torch.int64, device=self.device)
        self.map, _ = local_mapping.local_bundle_adjustment_impl(self.map, one, self._K, self._bf)
        self.map = _renormalize_scale(self.map)
        self.ref_kf = 1
        self.last_frame = frame._replace(pose=self.map.kf_pose[1], mp=self.map.kf_mp[1])
        self.n_kf_host = 2
        self.last_kf_frame = self.frame_id
        self.init_ref = None
        return True

    def _record(self, timestamp, Tcw: torch.Tensor, lost=False) -> np.ndarray:
        """Append an absolute pose to the trajectory; returns it as numpy."""
        Tcw_np, ref_pose = sync.host_numpy(Tcw, self.map.kf_pose[self.ref_kf])
        self.trajectory.append(timestamp, self.ref_kf, Tcw_np, ref_pose, lost=lost)
        return Tcw_np

    def _settled_map(self) -> MapState:
        """The newest map once every in-flight frame is decided and the
        trajectory follows the keyframes the workers erased."""
        self.flush()
        self._apply_redirects()
        self._refresh_from_box()
        return self.map

    def _kf_poses(self) -> np.ndarray:
        (poses,) = sync.host_numpy(self._settled_map().kf_pose)
        return poses

    def save_map(self, path):
        """Write the map in the reference's npz format, with the tracker's
        reference keyframe, live keyframe count and frame id (System::SaveMap,
        src/System.cc:807-848)."""
        serialization.save_map(self._settled_map(), path,
                               metadata={"ref_kf": self.ref_kf, "n_kf_host": self.n_kf_host,
                                         "frame_id": self.frame_id})

    def load_map(self, path):
        """Load a map (either package's file) and start LOST, so the next
        frames relocalize in it (System::LoadMap, src/System.cc:849-994;
        Tracking starts LOST, src/Tracking.cc:148-149). The BoW database is
        rebuilt from the keyframes. In async mode the workers are stopped
        without draining (their queued rounds belong to the old map) and
        started again on the loaded one."""
        self.flush()
        self._apply_redirects()
        restart = self._halt_workers()
        self.map, meta = serialization.load_map(path, device=self.device)
        self.ref_kf = int(meta.get("ref_kf", 0))
        self.n_kf_host = int(meta.get("n_kf_host", sync.host(self.map.n_kf)))
        self.frame_id = int(meta.get("frame_id", 0))
        self.state = TrackState.LOST
        self._have_velocity = False
        self._last_Tcw = None
        self.last_frame = None
        self._reloc_join = False
        if self.vocab is not None:
            self.loop_closer.db = serialization.rebuild_database(self.map, self.vocab, self.config.max_keyframes,
                                                                 self.config.n_features)
        if restart:
            self._loops_seen = 0
            self._start_async()

    def save_trajectory_tum(self, path):
        self.trajectory.save_tum(path, self._kf_poses())

    def save_trajectory_kitti(self, path):
        self.trajectory.save_kitti(path, self._kf_poses())

    # ------------------------------------------------------------------
    # Pose/graph export (the reference's ROS-facing surface).
    def get_pose_array(self) -> list[np.ndarray]:
        """Tcw of every live keyframe in id order (System::GetPoseArray,
        src/System.cc:751-785)."""
        m = self._settled_map()
        valid, poses = sync.host_numpy(m.kf_valid, m.kf_pose)
        return [poses[i] for i in range(len(valid)) if valid[i]]

    def get_graph(self) -> dict:
        """Pose-graph snapshot (the `get_graph` service, src/ros_rgbd.cc:
        67-108): live keyframe ids and poses, consecutive-id links, and the
        covisibility edges of weight >= 15."""
        m = self._settled_map()
        valid, poses, cov = sync.host_numpy(m.kf_valid, m.kf_pose, covisibility(m))
        ids = [i for i in range(len(valid)) if valid[i]]
        links = [{"fromId": a, "toId": b} for a, b in zip(ids[:-1], ids[1:])]
        ii, jj = np.nonzero(np.triu(cov, 1) >= 15)
        covis_edges = [{"fromId": int(a), "toId": int(b), "weight": int(cov[a, b])} for a, b in zip(ii, jj)]
        return {"posesId": ids, "poses": [poses[i] for i in ids], "links": links, "covisibility": covis_edges}

    # Odometry-frame pose chain (src/Tracking.cc:528-557): frame-to-frame
    # motion accumulated into an odometry frame that never jumps on loop
    # closure or relocalization (the /odom -> base_link TF analog).
    def _update_odom(self, Tcw: np.ndarray):
        if self._odom_Tcw is None:
            self._odom_Tcw = Tcw.copy()
        elif self._last_Tcw is not None:
            diff_twc = Tcw @ np.linalg.inv(self._last_Tcw)  # mPoseDiff.mTwc
            self._odom_Tcw = diff_twc @ self._odom_Tcw
        self._last_Tcw = Tcw.copy()

    def _sync_odom_from_device(self):
        """Fold the device-side odometry chain back into the host chain (on
        a pipeline flush, so the sync path resumes from the right frame)."""
        if self._odom_dev is not None:
            (odom,) = sync.host_numpy(self._odom_dev)
            self._odom_Tcw = odom.astype(np.float64)
            self._odom_dev = None
            self._last_Tcw = None

    @property
    def odom_pose(self) -> np.ndarray | None:
        """T_cam_odom (4,4) in the odometry frame, or None before tracking.
        On the pipelined path this reads the device-side chain (one counted
        transfer, paid by the caller who asked)."""
        if self._odom_dev is not None:
            (odom,) = sync.host_numpy(self._odom_dev)
            return odom.astype(np.float64)
        return None if self._odom_Tcw is None else self._odom_Tcw.copy()


def _live_associations(mp: torch.Tensor, snap: MapState, live: MapState) -> torch.Tensor:
    """A frame's point ids from the snapshot `snap`, -1 where the slot no
    longer holds the same point in `live` (see `_insert_keyframe_async`)."""
    m = torch.clamp(mp, min=0).long()
    same = (mp >= 0) & snap.mp_valid[m] & live.mp_valid[m] & (snap.mp_first_seq[m] == live.mp_first_seq[m])
    return torch.where(same, mp, -1)


def _renormalize_scale(state: MapState) -> MapState:
    """Scale the map so that keyframe 0's median scene depth is 1 (the
    monocular gauge after the initial BA, src/Tracking.cc:832-856)."""
    pose0 = state.kf_pose[0]
    mp0 = state.kf_mp[0]
    has = (mp0 >= 0) & state.kf_kp_valid[0]
    z = state.mp_pos[torch.clamp(mp0, min=0).long()] @ pose0[2, :3] + pose0[2, 3]
    s = 1.0 / torch.clamp(torch.nanquantile(torch.where(has, z, float("nan")), 0.5), min=1e-6)
    kf_pose = state.kf_pose.clone()
    kf_pose[:, :3, 3] *= s
    return state._replace(kf_pose=kf_pose, mp_pos=state.mp_pos * s)


def _odom_step(odom: torch.Tensor, diff_twc: torch.Tensor) -> torch.Tensor:
    """One odometry-chain update on the device, without a host read (the
    pipelined path): odom' = diff @ odom, re-orthonormalized."""
    return lie.orthonormalize(diff_twc @ odom)
