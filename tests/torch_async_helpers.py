"""Shared helpers of the async tests (`test_torch_async*.py`,
`test_torch_pipelined.py`): the settled schedule and the parity checks of
two `SlamSystem` runs. Not a test module.

The async mode runs local mapping and loop closing on the native runtime's
worker threads, so which rounds skip their BA depends on thread timing. The
settled schedule takes that out: after every `track_*` call, `settle` waits
until the `AsyncMapper` has finished a mapping round for every submitted
keyframe and a loop round for each (a test-side counter on
`submit_keyframe` and on the loop service hook, the same for both packages).
Every wait is bounded.
"""

import time

import numpy as np

from orb_slam2v2_1_tpu.models import system as jsystem
from orb_slam2v2_1_tpu.utils import config as jconfig

from orb_slam2v2_1_tpu_torch.models import system
from orb_slam2v2_1_tpu_torch.utils import config

SETTLE_S = 120.0


def instrument(slam):
    """Count submitted keyframes and finished loop rounds on the slam's
    AsyncMapper (instance attributes shadow the methods the tracker and the
    loop worker call)."""
    m = slam._mapper
    m.test_submitted = m.test_loop_rounds = 0
    submit, service = m.submit_keyframe, m._loop_service_fn

    def submit_counted(kf_id, *frame):
        submit(kf_id, *frame)
        m.test_submitted += 1

    def service_counted():
        service()
        m.test_loop_rounds += 1

    m.submit_keyframe = submit_counted
    m._loop_service_fn = service_counted
    return slam


def settle(slam, timeout=SETTLE_S):
    """Wait until every submitted keyframe has had its mapping round and its
    loop round; raises a worker's error, fails after `timeout` seconds."""
    m = slam._mapper
    deadline = time.monotonic() + timeout
    while not (m.n_processed == m.test_submitted and m.test_loop_rounds == m.test_submitted):
        m.raise_worker_errors()
        assert time.monotonic() < deadline, "the async workers did not settle"
        time.sleep(0.002)
    m.raise_worker_errors()


def run_settled(slam, frames, track):
    outs = []
    for i, (a, b) in enumerate(frames):
        outs.append(track(a, b, i * 0.1))
        settle(slam)
    return outs


def centers(poses):
    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in np.asarray(poses, np.float64)])


def assert_poses_close(got, ref, mm=2.0, deg=0.05):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    dc = np.linalg.norm(centers(got) - centers(ref), axis=1)
    assert dc.max() <= mm * 1e-3, dc
    R = np.einsum("fji,fjk->fik", got[:, :3, :3], ref[:, :3, :3])
    ang = np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert ang.max() <= deg, ang


def assert_runs_agree(jslam, tslam, jout, tout, min_kf=2):
    assert [o is None for o in tout] == [o is None for o in jout]
    assert_poses_close([o for o in tout if o is not None], [o for o in jout if o is not None])
    assert tslam.n_kf_host == jslam.n_kf_host >= min_kf
    js, ts = jslam.stats(), tslam.stats()
    assert set(ts) == set(js)
    for key in ("state", "n_kf", "n_loops", "n_frames", "n_resets", "in_flight", "ba_skipped", "gba_ms_last"):
        assert ts[key] == js[key], key
    assert tslam._mapper.n_processed == jslam._mapper.n_processed >= 1


def pair(sensor_name, kw):
    """A settled-instrumented async SlamSystem of each package."""
    jslam = jsystem.SlamSystem(config=jconfig.SlamConfig(**kw), sensor=jsystem.Sensor[sensor_name],
                               async_mapping=True)
    tslam = system.SlamSystem(config=config.SlamConfig(**kw), sensor=system.Sensor[sensor_name], device="cpu",
                              async_mapping=True)
    return instrument(jslam), instrument(tslam)


