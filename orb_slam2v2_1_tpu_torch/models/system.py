"""SLAM system facade: the host-side state machine of the online entry point.

Port of the JAX package's `models/system.py` in its synchronous mode
(`async_mapping=False, pipelined=False`) for the monocular, RGB-D and stereo
sensors: the reference `System` + `Tracking` state machine
(src/System.cc:38-537, src/Tracking.cc:376-649). Each `track_monocular` /
`track_rgbd` / `track_stereo` call builds the frame, tracks it
(`frontend.track_frame_impl`), reads its decision vector, pose and relative
pose in one counted transfer, and then decides on the host: relocalization
on loss, the early-loss reset, the localization-mode visual odometry, the
keyframe policy, keyframe insertion with local mapping, and a loop-closing
round after each insertion. Before the first keyframe, a depth sensor
initializes from one frame and a monocular camera from two
(`ops.twoview.initialize_two_view`, seeded by the frame id).

Not ported yet, each raising NotImplementedError: `async_mapping=True` and
`pipelined=True` (their worker threads), a `mesh` of more than one device,
the map server (`connect_server`, `fetch_server_map`, `poll_server_push`),
`save_map` / `load_map` and `warmup`.
"""

from __future__ import annotations

import enum
import os
import time as _time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as device_mod
from .. import sync
from ..ops import lie, orb, twoview
from ..ops import vocab as vocab_ops
from ..utils.config import SlamConfig
from ..utils.trajectory import Trajectory
from . import frontend, initialization, local_mapping, relocalization
from . import keyframe_database as kdb
from .loop_closing import LoopCloser
from .map_state import MapState, covisibility, empty_map
from .tracking import FrameData

# The shared vocabulary, read in place from the reference package's data.
VOCAB_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "orb_slam2v2_1_tpu", "data",
                         "vocab.npz")


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (the port runs SlamSystem in sync mode)")


@dataclass
class SlamSystem:
    config: SlamConfig
    sensor: Sensor = Sensor.MONOCULAR
    async_mapping: bool = False
    pipelined: bool = False
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
        if self.async_mapping:
            raise _not_ported("async_mapping=True")
        if self.mesh == "auto":
            self.mesh = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if self.mesh is not None and len(self.mesh) > 1:
            raise _not_ported("a mesh of more than one device")
        self.mesh = None
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
        self._odom_Tcw = None
        self._last_Tcw = None
        self._vo_mode = False  # mbVO analog (src/Tracking.cc:434-501)
        self.n_resets = 0
        # Relocalizations that succeeded (a frame tracked after loss through
        # the reference keyframe is not one).
        self.n_relocalized = 0
        self._pose_listeners = []
        # Rolling per-stage latency (ms), see stats(); in sync mode mapping
        # and loop closing run inside the track call.
        self._metrics = {"track": deque(maxlen=512), "map": deque(maxlen=128), "loop": deque(maxlen=128)}

    def _init_recognition(self):
        """Vocabulary + keyframe database + loop closer (the System
        constructor loads the vocabulary and wires LoopClosing,
        src/System.cc:76-130). Sync mode runs global BA inline."""
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

    def shutdown(self, drain: bool = True):
        """Sync mode: no worker runs beside the tracker; nothing to stop."""

    def flush(self):
        """Sync mode: every frame is decided when its call returns."""

    def connect_server(self, host: str, port: int, client_id: int):
        raise _not_ported("the map server connection")

    def fetch_server_map(self, merge_with: int | None = None):
        raise _not_ported("the map server connection")

    def poll_server_push(self) -> bool:
        raise _not_ported("the map server connection")

    def save_map(self, path):
        raise _not_ported("save_map")

    def load_map(self, path):
        raise _not_ported("load_map")

    def warmup(self, *args, **kwargs):
        raise _not_ported("warmup")

    # ------------------------------------------------------------------
    # Public per-frame entry points (System::TrackMonocular / TrackRGBD /
    # TrackStereo)
    # ------------------------------------------------------------------
    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def track_monocular(self, img, timestamp: float):
        t0 = _time.perf_counter()
        out = self._step(img, None, timestamp)
        self._metrics["track"].append((_time.perf_counter() - t0) * 1e3)
        return out

    def track_rgbd(self, img, depth, timestamp: float):
        t0 = _time.perf_counter()
        out = self._step(img, depth, timestamp)
        self._metrics["track"].append((_time.perf_counter() - t0) * 1e3)
        return out

    def track_stereo(self, img_left, img_right, timestamp: float):
        """Stereo entry point (System::TrackStereo, src/System.cc:365-423):
        the frame is built from the rectified pair, then tracked as an RGB-D
        frame (ur and depth from the disparity)."""
        t0 = _time.perf_counter()
        frame = frontend.build_frame_stereo(
            self._tensor(img_left), self._tensor(img_right), self._K, self._dist, self._bf,
            self.frame_id, self._orb_cfg,
        )
        out = self._step_built(frame, timestamp)
        self._metrics["track"].append((_time.perf_counter() - t0) * 1e3)
        return out

    def _step(self, img, depth, timestamp: float):
        c = self.config
        img_t = self._tensor(img)
        depth_t = None if depth is None else self._tensor(depth)
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            frame = frontend.build_frame_only(img_t, depth_t, self._K, self._dist, self._bf, self.frame_id,
                                              self._orb_cfg, c.width, c.height)
            return self._first_frame(frame, timestamp)
        res = frontend.process_frame_impl(
            self.map, img_t, depth_t, self.last_frame, self._velocity_dev, self._have_velocity, self.ref_kf,
            self._K, self._dist, self._bf, self._depth_limit, self.frame_id, self._orb_cfg, c.width, c.height,
            self.vocab, vo_points=self._vo_points_enabled(), mono=self.sensor == Sensor.MONOCULAR,
        )
        return self._handle_result(res, timestamp)

    def _step_built(self, frame: FrameData, timestamp: float):
        """Shared tracking for a frame built by the caller (stereo path)."""
        c = self.config
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            return self._first_frame(frame, timestamp)
        res = frontend.track_frame_impl(
            self.map, frame, self.last_frame, self._velocity_dev, self._have_velocity, self.ref_kf, self._K,
            self._bf, self._depth_limit, c.width, c.height, self.vocab, vo_points=self._vo_points_enabled(),
        )
        return self._handle_result(res, timestamp)

    def _first_frame(self, frame: FrameData, timestamp: float):
        """A frame before initialization: bootstrap the map from it if it
        has enough keypoints."""
        self.state = TrackState.NOT_INITIALIZED
        ok = self._initialize(frame)
        self.frame_id += 1
        if not ok:
            return None
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
    # The per-frame decision
    # ------------------------------------------------------------------
    def _handle_result(self, res: frontend.FrameResult, timestamp: float):
        out = self._handle_result_impl(res, timestamp)
        self._publish_pose(timestamp, out)
        return out

    def _relocalize(self, frame: FrameData):
        out = relocalization.relocalize(self.map, self.loop_closer.db, self.vocab, frame, self._K, self._bf,
                                        self.frame_id)
        self.n_relocalized += int(out[0])
        return out

    def _accept_relocalization(self, res, timestamp, Tcw_r, frame_mp, ref):
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
        return out

    def _handle_result_impl(self, res: frontend.FrameResult, timestamp: float):
        # The single per-frame read: every host-needed output in one transfer.
        stats, pose_np, T_rel_np = sync.host_numpy(res.stats, res.pose, res.T_rel)
        self.map = res.state
        tracked_ok = stats[0] > 0

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
            self._insert_keyframe_fused(res.frame)
            # Mapping (cull/fuse) may have merged or killed points: re-read
            # this frame's associations from its own keyframe row.
            self.last_frame = res.frame._replace(mp=self.map.kf_mp[self.ref_kf])
            if self.loop_closer is not None:
                t0 = _time.perf_counter()
                self.map, closed = self.loop_closer.on_keyframe(self.map, self.ref_kf, self.n_kf_host)
                self._metrics["loop"].append((_time.perf_counter() - t0) * 1e3)
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

    def stats(self) -> dict:
        """Rolling runtime/health snapshot with the reference's keys:
        per-stage latency percentiles (ms), map/loop counters and the track
        state. No device read."""

        def pct(xs, q):
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
            "in_flight": 0,
            "ba_skipped": 0,
        }

    def activate_localization_mode(self):
        """Tracking-only mode: no new keyframes or map mutation
        (System::ActivateLocalizationMode, src/System.cc:539-547)."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def reset(self):
        """Clear the map and restart (System::Reset -> Tracking::Reset,
        src/Tracking.cc:1650-1698)."""
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
        self._vo_mode = False
        self.n_resets += 1
        self.trajectory = Trajectory()
        if self.loop_closer is not None and self.loop_closer.gba_runner is not None:
            # Abort any detached solve before discarding the old closer.
            self.loop_closer.gba_runner.abort()
            self.loop_closer.gba_runner.join()
        self._init_recognition()

    def _need_new_keyframe_stats(self, stats) -> bool:
        """NeedNewKeyFrame on the decision vector (the thresholds of
        src/Tracking.cc:1120-1204): monocular wants 90% of the reference
        keyframe's points and has no close-point trigger."""
        n_inliers = stats[1]
        ref_matches = stats[3]
        frames_since = self.frame_id - self.last_kf_frame
        mono = self.sensor == Sensor.MONOCULAR
        c1a = frames_since >= self._max_frames
        c1b = frames_since >= max(self._min_frames, 1)
        c2 = (n_inliers < ref_matches * (0.9 if mono else 0.75)) and n_inliers > 15
        need_close = not mono and self.config.bf > 0 and stats[4] < 100 and stats[5] > 70
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
        self.map, victim, vparent, T_red = local_mapping.cull_keyframes(self.map, self.ref_kf, force=True)
        v, p, T = sync.host_numpy(victim, vparent, T_red)
        self._apply_cull(int(v), int(p), T)

    def _insert_keyframe_fused(self, frame: FrameData):
        t0 = _time.perf_counter()
        depth_limit = 0.0 if self.sensor == Sensor.MONOCULAR else self._depth_limit
        self.map, kf_id, _, victim, vparent, T_redirect = frontend.insert_keyframe_fused_impl(
            self.map, frame, self._K, self._bf, depth_limit, self.vocab,
        )
        kf, v, p, T = sync.host_numpy(kf_id, victim, vparent, T_redirect)
        self._metrics["map"].append((_time.perf_counter() - t0) * 1e3)
        self.ref_kf = int(kf)
        self.n_kf_host += 1
        self.last_kf_frame = self.frame_id
        self._apply_cull(int(v), int(p), T)

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
        gen = torch.Generator(device=self.device).manual_seed(self.frame_id)
        res = twoview.initialize_two_view(self.init_ref.xy, frame.xy[m.idx], m.ok, self._K, generator=gen)
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

    def _kf_poses(self) -> np.ndarray:
        (poses,) = sync.host_numpy(self.map.kf_pose)
        return poses

    def save_trajectory_tum(self, path):
        self.trajectory.save_tum(path, self._kf_poses())

    def save_trajectory_kitti(self, path):
        self.trajectory.save_kitti(path, self._kf_poses())

    # ------------------------------------------------------------------
    # Pose/graph export (the reference's ROS-facing surface).
    def get_pose_array(self) -> list[np.ndarray]:
        """Tcw of every live keyframe in id order (System::GetPoseArray,
        src/System.cc:751-785)."""
        valid, poses = sync.host_numpy(self.map.kf_valid, self.map.kf_pose)
        return [poses[i] for i in range(len(valid)) if valid[i]]

    def get_graph(self) -> dict:
        """Pose-graph snapshot (the `get_graph` service, src/ros_rgbd.cc:
        67-108): live keyframe ids and poses, consecutive-id links, and the
        covisibility edges of weight >= 15."""
        valid, poses, cov = sync.host_numpy(self.map.kf_valid, self.map.kf_pose, covisibility(self.map))
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

    @property
    def odom_pose(self) -> np.ndarray | None:
        """T_cam_odom (4,4) in the odometry frame, or None before tracking."""
        return None if self._odom_Tcw is None else self._odom_Tcw.copy()


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
    reference's pipelined path): odom' = diff @ odom, re-orthonormalized."""
    return lie.orthonormalize(diff_twc @ odom)
