"""Each frozen copy in slam_bench/reference agrees with the port's own
function on small inputs (the CPU; the port's plain versions)."""

import numpy as np
import pytest
import torch

from orb_slam2v2_1_tpu_torch.ops import orb as port_orb
from orb_slam2v2_1_tpu_torch.utils import synthetic as port_syn
from orb_slam2v2_1_tpu_torch.utils import trajectory as port_traj
from slam_bench.reference import orb as orb_ref
from slam_bench.reference import scene as scene_ref
from slam_bench.reference import trajectory as traj_ref


@pytest.fixture(scope="module")
def rooms():
    return (scene_ref.make_room(np.random.default_rng(11), "cpu"),
            port_syn.make_room(np.random.default_rng(11), device="cpu"))


def test_room_and_textures_equal(rooms):
    ref, port = rooms
    for a, b in zip(ref, port):
        assert torch.equal(a, b)
    assert torch.equal(scene_ref.make_room(np.random.default_rng(11), "cpu", 6).tex, port.tex[:6])


def test_paths_agree():
    for k in (0, 1, 80, 161, 320):
        # float64 Rodrigues against the port's float32 one, entries up to 3 m: a few float32 ulps.
        np.testing.assert_allclose(scene_ref.orbit_pose(k, 321), port_syn.orbit_pose(k, 321), atol=5e-6)
    for i in (0, 7, 59):
        np.testing.assert_array_equal(scene_ref.dolly_pose(i, 0.08, 0.05), port_syn.dolly_pose(i, 0.08, 0.05))


@pytest.mark.parametrize("k", [0, 100])
def test_render_agrees(rooms, k):
    ref, port = rooms
    K = (60.0, 60.0, 40.0, 30.0)
    Tcw = torch.from_numpy(scene_ref.orbit_pose(k, 321))
    a = scene_ref.render(ref, Tcw, K, 80, 60)
    b = port_syn.render(port, Tcw, torch.tensor(K), 80, 60)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=1e-3, rtol=1e-5)


def test_plain_orb_equals_the_ports(rooms):
    room = scene_ref.PlaneScene(*(t[:6] for t in rooms[0]))
    img, _ = scene_ref.render(room, torch.from_numpy(scene_ref.orbit_pose(30, 321)), (275.0, 275.0, 160.0, 120.0),
                              320, 240)
    ref = orb_ref.extract(img, 1000, 8, 1.2)
    port = port_orb.extract_orb(img, port_orb.OrbConfig(n_features=1000, n_levels=8, scale=1.2))
    assert ref.valid.sum() > 500
    assert torch.equal(ref.valid, port.valid)
    assert torch.equal(ref.level, port.level.long())
    assert torch.equal(ref.xy[ref.valid], port.xy[port.valid])
    bits = torch.stack([(port.desc.long() >> b) & 1 for b in range(32)], -1).reshape(-1, 256).bool()
    assert torch.equal(ref.bits[ref.valid], bits[port.valid])


def test_ate_agrees_with_the_ports():
    rng = np.random.default_rng(0)
    gt = [np.eye(4) for _ in range(20)]
    est = []
    for i, T in enumerate(gt):
        T[:3, 3] = (0.1 * i, 0.02 * i * i, -0.05 * i)
        E = np.eye(4)
        E[:3, :3] = scene_ref.so3_exp([0.1, -0.2, 0.3])
        E[:3, 3] = T[:3, 3] @ E[:3, :3].T + 0.5 + rng.normal(0, 0.01, 3)
        est.append(E)
    gt_c = np.stack([T[:3, 3] for T in gt])
    est_c = np.stack([E[:3, 3] for E in est])
    ours = float(np.sqrt(np.mean(traj_ref.aligned_errors(est_c, gt_c) ** 2)))
    theirs = port_traj.ate_rmse([(i * 0.1, E) for i, E in enumerate(est)], {i * 0.1: T for i, T in enumerate(gt)},
                                align_scale=False)
    assert ours == pytest.approx(theirs, rel=1e-9)
    assert 0.005 < ours < 0.03


def test_similarity_ate_agrees_with_the_ports():
    """A monocular run's alignment: the estimate at 0.37 of the truth's scale."""
    rng = np.random.default_rng(1)
    gt_c = np.stack([(0.1 * i, 0.02 * i * i, -0.05 * i) for i in range(20)])
    R = scene_ref.so3_exp([0.1, -0.2, 0.3])
    est_c = 0.37 * gt_c @ R.T + 0.5 + rng.normal(0, 0.004, gt_c.shape)
    gt, est = [], []
    for g, e in zip(gt_c, est_c):
        gt.append(np.eye(4))
        gt[-1][:3, 3] = g
        est.append(np.eye(4))
        est[-1][:3, 3] = e
    ours = float(np.sqrt(np.mean(traj_ref.aligned_errors(est_c, gt_c, with_scale=True) ** 2)))
    theirs = port_traj.ate_rmse([(i * 0.1, E) for i, E in enumerate(est)], {i * 0.1: T for i, T in enumerate(gt)},
                                align_scale=True)
    assert ours == pytest.approx(theirs, rel=1e-9)
    assert 0.003 < ours < 0.03
    assert traj_ref.umeyama(est_c, gt_c, with_scale=True)[0] == pytest.approx(1 / 0.37, rel=0.02)
    assert float(np.sqrt(np.mean(traj_ref.aligned_errors(est_c, gt_c) ** 2))) > 0.3


def test_orientation_error_is_relative_to_the_first_pose():
    R = [scene_ref.so3_exp([0.0, 0.1 * i, 0.0]) for i in range(5)]
    gt = np.stack([np.block([[r, np.zeros((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]]) for r in R])
    est = gt.copy()
    est[:, :3, :3] = est[:, :3, :3] @ scene_ref.so3_exp([0.3, 0.0, 0.0])  # one fixed offset: no error
    np.testing.assert_allclose(traj_ref.rotation_errors_deg(est, gt), 0.0, atol=1e-6)
    est[4, :3, :3] = scene_ref.so3_exp([0.0, 0.0, np.radians(2.0)]) @ est[4, :3, :3]
    assert traj_ref.rotation_errors_deg(est, gt)[4] == pytest.approx(2.0, abs=1e-6)
