"""`SlamSystem(mesh=...)` of the PyTorch port against the JAX package (CPU):
the product route of the sharded local BA.

The 14 desk frames of tests/test_dist_product.py (640x480, 1000 features,
`desk_trajectory(14, extent=0.5)` relative to its first pose), rendered once
and fed as the same numpy frames to both packages. The JAX package shards
over its 8 virtual CPU devices, the port over a mesh of 8 "cpu" entries. In
sync mode and in async mode (the settled schedule of
`tests/torch_async_helpers.py`, so both packages' workers run the same
rounds) the port keeps as many keyframes as the reference's sharded run, its
ATE stays under the reference test's 0.05 m, and every local BA round went
through the sharded route (in async mode on the mapping worker's thread).
The pose gap between the two packages' keyframes is printed, not bounded:
the two LM engines stop on their own float orders (`test_torch_dist_ba.py`).
"""

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh as JMesh

from orb_slam2v2_1_tpu.models import system as jsystem
from orb_slam2v2_1_tpu.utils import config as jconfig

from orb_slam2v2_1_tpu_torch import sync
from orb_slam2v2_1_tpu_torch.models import local_mapping, system
from orb_slam2v2_1_tpu_torch.parallel import mesh as mesh_mod
from orb_slam2v2_1_tpu_torch.utils import config, synthetic
from orb_slam2v2_1_tpu_torch.utils.trajectory import ate_rmse

from tests.torch_async_helpers import instrument, settle

torch.set_num_threads(2)

KW = dict(fx=550.0, fy=550.0, cx=320.0, cy=240.0, width=640, height=480, n_features=1000, max_keyframes=32,
          max_map_points=8192, fps=10.0, bf=44.0, th_depth=100.0)
N_FRAMES = 14
ATE_BOUND = 0.05  # tests/test_dist_product.py


@pytest.fixture(scope="module")
def seq():
    cfg = config.SlamConfig(**KW)
    imgs, deps, gt = synthetic.desk_frames(cfg, synthetic.desk_trajectory(N_FRAMES, extent=0.5), device="cpu")
    return list(zip(imgs.numpy(), deps.numpy())), gt


def _ate(slam, gt):
    est = slam.trajectory.absolute_poses(np.asarray(slam.map.kf_pose))
    return ate_rmse(est, {i * 0.1: np.linalg.inv(gt[i]) for i in range(len(gt))}, align_scale=False)


def _kf_gap(jslam, tslam):
    """Largest camera-center distance between the two packages' keyframes,
    slot by slot, in metres."""
    def centers(slam):
        P = np.asarray(slam.map.kf_pose, np.float64)[np.asarray(slam.map.kf_valid)]
        return np.stack([-p[:3, :3].T @ p[:3, 3] for p in P])

    a, b = centers(jslam), centers(tslam)
    return float(np.linalg.norm(a - b, axis=1).max()) if a.shape == b.shape else float("nan")


def _spy_local_ba(monkeypatch):
    """Record the thread role of each sharded local BA."""
    roles, real = [], local_mapping.local_bundle_adjustment_dist

    def spied(*a, **k):
        roles.append(sync.role())
        return real(*a, **k)

    monkeypatch.setattr(local_mapping, "local_bundle_adjustment_dist", spied)
    return roles


def test_mesh_auto_resolves(monkeypatch):
    """`mesh="auto"` means every visible card, as the reference's means
    every JAX device: none here, so no mesh; with two cards visible, a mesh
    over both. A list of devices becomes a mesh, and the loop closer
    inherits the system's mesh for its global-BA route."""
    cfg = config.SlamConfig(**KW)
    slam = system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, mesh="auto", device="cpu")
    assert slam.mesh is None and slam.loop_closer.mesh is None
    jslam = jsystem.SlamSystem(config=jconfig.SlamConfig(**KW), sensor=jsystem.Sensor.RGBD, mesh="auto")
    assert jslam.mesh.size == jax.device_count() == 8 and jslam.loop_closer.mesh is jslam.mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    two = mesh_mod.resolve("auto")
    assert two.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    slam = system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, mesh=["cpu"] * 8, device="cpu")
    assert slam.mesh.size == 8 and slam.loop_closer.mesh is slam.mesh


def test_product_local_ba_sharded_sync(seq, monkeypatch):
    """Sync mode: the port over 8 "cpu" shards keeps the reference's sharded
    run's keyframe count (>= 2), ATE < 0.05 m, and every keyframe's window
    went through the sharded route."""
    frames, gt = seq
    jslam = jsystem.SlamSystem(config=jconfig.SlamConfig(**KW), sensor=jsystem.Sensor.RGBD,
                               mesh=JMesh(np.array(jax.devices()), ("obs",)))
    for i, (im, d) in enumerate(frames):
        jslam.track_rgbd(im, d, timestamp=i / 10.0)
    roles = _spy_local_ba(monkeypatch)
    tslam = system.SlamSystem(config=config.SlamConfig(**KW), sensor=system.Sensor.RGBD, mesh=["cpu"] * 8,
                              device="cpu")
    for i, (im, d) in enumerate(frames):
        tslam.track_rgbd(im, d, timestamp=i / 10.0)
    ate = _ate(tslam, gt)
    print(f"sync: keyframes {tslam.n_kf_host} (reference {jslam.n_kf_host}), ATE {ate:.5f} m "
          f"(reference {_ate(jslam, gt):.5f}), keyframe gap {_kf_gap(jslam, tslam):.5f} m")
    assert tslam.n_kf_host == jslam.n_kf_host >= 2
    assert ate < ATE_BOUND
    assert roles == ["tracker"] * (tslam.n_kf_host - 1)


def _run_settled(slam, frames):
    """`torch_async_helpers.run_settled` across a reset: both packages lose
    frame 2 of this sweep in async mode and reset (a new mapper, counted
    afresh; the next frame initializes without a mapping round)."""
    for i, (im, d) in enumerate(frames):
        slam.track_rgbd(im, d, i * 0.1)
        if not hasattr(slam._mapper, "test_submitted"):
            instrument(slam)
        settle(slam)


def test_product_async_sharded(seq, monkeypatch):
    """Async mode under the settled schedule: the mapping worker solves each
    window through the sharded route; the keyframe and reset counts equal
    the reference's sharded async run's and the ATE stays under 0.05 m."""
    frames, gt = seq
    jslam = jsystem.SlamSystem(config=jconfig.SlamConfig(**KW), sensor=jsystem.Sensor.RGBD, async_mapping=True,
                               mesh=JMesh(np.array(jax.devices()), ("obs",)))
    try:
        _run_settled(jslam, frames)
    finally:
        jslam.shutdown()
    roles = _spy_local_ba(monkeypatch)
    tslam = system.SlamSystem(config=config.SlamConfig(**KW), sensor=system.Sensor.RGBD, async_mapping=True,
                              mesh=["cpu"] * 8, device="cpu")
    try:
        _run_settled(tslam, frames)
    finally:
        tslam.shutdown()
    ate = _ate(tslam, gt)
    print(f"async: keyframes {tslam.n_kf_host} (reference {jslam.n_kf_host}), ATE {ate:.5f} m "
          f"(reference {_ate(jslam, gt):.5f}), keyframe gap {_kf_gap(jslam, tslam):.5f} m")
    assert tslam.n_kf_host == jslam.n_kf_host >= 2 and tslam.n_resets == jslam.n_resets
    assert ate < ATE_BOUND
    assert roles and set(roles) == {"mapping"}
