"""A relocalization that joins two unjoined parts of the map closes the loop
between them (port only; CPU).

On a revisit, a tracker that loses track on the drifted second pass and
relocalizes on a first-pass keyframe then follows the first pass: its new
keyframes are covisible with the first pass, and loop detection, which skips
covisible candidates, never closes the loop. The drift of the second pass
before the loss stays in the map (seen on the card: `bench.py`'s online leg,
frame 274 relocalized on the keyframe of frame 114, no loop closed, ATE
0.56 m against 0.28-0.29 m with the closure). The port hands such a pair to
the loop closer (`SlamSystem._join_after_relocalization`,
`LoopCloser.detect_join`); the reference does not.

The map is `test_torch_loop.py`'s ring of 20 keyframes whose keyframes 16-19
see keyframes 0-3's structure again through duplicated landmarks under a
drift of 0.25 m: tracking was on keyframe 16 and relocalizes on keyframe 0.
In sync mode the closure runs in the call, in async mode on the loop
worker. Keyframe 16's camera center moves from 0.3 m to within 0.05 m of
the truth; a pair that is already covisible, or a map loaded from a file,
closes nothing.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_loop import K_NP, RING_KFS, loop_map_arrays

from orb_slam2v2_1_tpu_torch.models import map_state, system
from orb_slam2v2_1_tpu_torch.models.tracking import FrameData
from orb_slam2v2_1_tpu_torch.ops import hamming
from orb_slam2v2_1_tpu_torch.utils import config, serialization

torch.set_num_threads(2)

KCAP, MCAP, N = 32, 2048, 192


@pytest.fixture(scope="module")
def arrays():
    return loop_map_arrays(np.random.default_rng(1), Kcap=KCAP, Mcap=MCAP, N=N)[0]


def _truth_center(k):
    th = np.radians(22.5 * k)
    return 0.5 * np.array([np.sin(th), 0.0, np.cos(th)])


def _center(T):
    T = np.asarray(T, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def _system(arrays, async_mapping):
    cfg = config.SlamConfig(fx=float(K_NP[0]), fy=float(K_NP[1]), cx=float(K_NP[2]), cy=float(K_NP[3]), width=320,
                            height=240, n_features=N, max_keyframes=KCAP, max_map_points=MCAP, bf=40.0)
    slam = system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, async_mapping=async_mapping, device="cpu")
    slam.map = map_state.from_numpy(arrays, device="cpu")
    slam.loop_closer.db = serialization.rebuild_database(slam.map, slam.vocab, KCAP, N)
    slam.loop_closer.kf_counter = RING_KFS
    slam._publish_fresh_map()
    slam.state = system.TrackState.OK
    slam.ref_kf = 16
    slam.n_kf_host = RING_KFS
    slam.frame_id = 60
    return slam


def _relocalize_on(slam, kf):
    """Accept a relocalization of keyframe 16's view on keyframe `kf`, as
    the tracker does after a loss."""
    st = slam.map
    frame = FrameData(xy=st.kf_xy[16], level=st.kf_level[16], angle=st.kf_angle[16], desc=st.kf_desc[16],
                      desc_pm1=hamming.unpack_pm1(st.kf_desc[16]), kp_valid=st.kf_kp_valid[16], ur=st.kf_ur[16],
                      depth=torch.full((N,), -1.0), pose=st.kf_pose[16], mp=st.kf_mp[16],
                      frame_id=torch.tensor(60, dtype=torch.int32))
    return slam._accept_relocalization(SimpleNamespace(frame=frame), 6.0, st.kf_pose[kf], st.kf_mp[kf], kf)


@pytest.mark.parametrize("async_mapping", [False, True])
def test_relocalization_on_first_pass_closes_the_loop(arrays, async_mapping):
    slam = _system(arrays, async_mapping)
    try:
        before = np.linalg.norm(_center(arrays["kf_pose"][16]) - _truth_center(16))
        assert before > 0.25
        _relocalize_on(slam, 0)
        assert slam.state == system.TrackState.OK and slam.ref_kf == 0
    finally:
        slam.shutdown()
    assert slam.n_loops_closed == 1
    assert [c[1:] for c in slam.loop_closer.closures] == [(16, 0)]
    poses = slam.map.kf_pose.numpy()
    for k in (16, 17, 18, 19):
        assert np.linalg.norm(_center(poses[k]) - _truth_center(k)) < 0.05, k
    # The first pass is the loop's fixed side.
    np.testing.assert_allclose(poses[0], arrays["kf_pose"][0], atol=1e-4)
    assert int(slam.map.n_loop_edges) == 1


def test_covisible_pair_or_loaded_map_closes_nothing(arrays, tmp_path):
    slam = _system(arrays, False)
    _relocalize_on(slam, 15)  # keyframes 15 and 16 share points
    assert slam.n_loops_closed == 0 and slam.loop_closer.closures == []
    slam.save_map(tmp_path / "ring.npz")
    slam.load_map(tmp_path / "ring.npz")
    slam.ref_kf = 16
    _relocalize_on(slam, 0)  # the first relocalization in a loaded map
    assert slam.n_loops_closed == 0 and slam.loop_closer.closures == []
    np.testing.assert_allclose(slam.map.kf_pose.numpy()[16], arrays["kf_pose"][16], atol=1e-6)
