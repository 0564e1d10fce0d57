"""Dense point clouds and the offline viewer on both packages (CPU).

- `utils/pointcloud.py`: `backproject` within 1e-5 m with the same NaN rows;
  `voxel_downsample`, `occupancy_grid` and `build_octree` exact; the PLY,
  occupancy and octree files byte for byte the reference's; the gravity
  plane with the same generator within 1e-6; `DenseMapper`'s cloud within
  1e-5 m and its exports readable; `export_sparse_map_ply` byte-equal on a
  map carried across with `map_state.from_numpy`.
- `utils/viz.py`: `write_png` byte-equal; `draw_text` / `draw_frame` /
  `draw_map` arrays equal on the same inputs (the map carried across);
  `FrameRecorder` writes the reference's files.
"""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_loop import loop_map_arrays

from orb_slam2v2_1_tpu.models.map_state import MapState as JMapState
from orb_slam2v2_1_tpu.utils import pointcloud as jpc
from orb_slam2v2_1_tpu.utils import viz as jviz

from orb_slam2v2_1_tpu_torch.models import map_state
from orb_slam2v2_1_tpu_torch.utils import pointcloud as pc
from orb_slam2v2_1_tpu_torch.utils import viz

torch.set_num_threads(2)

K_NP = np.array([300.0, 300.0, 160.0, 120.0], np.float32)


@pytest.fixture(scope="module")
def ring():
    arrays = loop_map_arrays(np.random.default_rng(2))[0]
    return arrays, JMapState(**{k: jnp.asarray(v) for k, v in arrays.items()}), map_state.from_numpy(arrays,
                                                                                                    device="cpu")


def _depth(rng, h=60, w=80):
    d = 1.0 + 2.0 * rng.random((h, w)).astype(np.float32)
    d[rng.random((h, w)) < 0.2] = 0.0
    return d


def _pose(rng):
    from orb_slam2v2_1_tpu_torch.ops import lie

    return lie.se3_exp(torch.from_numpy((rng.standard_normal(6) * 0.3).astype(np.float32))).numpy()


@pytest.mark.parametrize("stride", [1, 3])
def test_backproject_parity(rng, stride):
    d, T = _depth(rng), _pose(rng)
    ref = np.asarray(jpc.backproject(jnp.asarray(d), jnp.asarray(T), jnp.asarray(K_NP), stride=stride))
    got = pc.backproject(torch.from_numpy(d), torch.from_numpy(T), torch.from_numpy(K_NP), stride=stride).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got[~np.isnan(got)], ref[~np.isnan(ref)], atol=1e-5)


def test_voxel_occupancy_octree_exact_and_files_equal(rng, tmp_path):
    pts = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
    pts[::17] = np.nan
    np.testing.assert_array_equal(pc.voxel_downsample(pts, 0.1), jpc.voxel_downsample(pts, 0.1))
    for a, b in zip(pc.occupancy_grid(pts, 0.2), jpc.occupancy_grid(pts, 0.2)):
        np.testing.assert_array_equal(a, b)
    finite = pts[np.isfinite(pts).all(1)]
    got_tree, ref_tree = pc.build_octree(finite, 0.1), jpc.build_octree(finite, 0.1)
    assert got_tree[0] == ref_tree[0] and got_tree[2:] == ref_tree[2:]
    np.testing.assert_array_equal(got_tree[1], ref_tree[1])
    colors = (rng.random((len(finite), 3)) * 255).astype(np.uint8)
    for name, write_got, write_ref in (
        ("cloud.ply", lambda p: pc.save_ply(pts, p), lambda p: jpc.save_ply(pts, p)),
        ("color.ply", lambda p: pc.save_ply(finite, p, colors), lambda p: jpc.save_ply(finite, p, colors)),
        ("occ.npz", lambda p: pc.save_occupancy(pts, p), lambda p: jpc.save_occupancy(pts, p)),
        ("tree.npz", lambda p: pc.save_octree(finite, p), lambda p: jpc.save_octree(finite, p)),
    ):
        write_got(tmp_path / f"got_{name}")
        write_ref(tmp_path / f"ref_{name}")
        if name.endswith(".npz"):
            a, b = np.load(tmp_path / f"got_{name}"), np.load(tmp_path / f"ref_{name}")
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            assert (tmp_path / f"got_{name}").read_bytes() == (tmp_path / f"ref_{name}").read_bytes()
    np.testing.assert_array_equal(pc.load_octree(tmp_path / "got_tree.npz"), jpc.load_octree(tmp_path / "ref_tree.npz"))


def test_gravity_plane_parity(rng):
    n = 1500
    floor = np.stack([rng.uniform(-3, 3, n), 1.5 + rng.normal(0, 0.01, n), rng.uniform(0, 6, n)], -1)
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    cloud = np.concatenate([floor, rng.uniform(-3, 3, (200, 3))]).astype(np.float32) @ R.T.astype(np.float32)
    ng, dg, ig = pc.fit_gravity_plane(cloud, np.random.default_rng(4))
    nr, dr, ir = jpc.fit_gravity_plane(cloud, np.random.default_rng(4))
    np.testing.assert_allclose(ng, nr, atol=1e-6)
    assert dg == pytest.approx(dr, abs=1e-6)
    np.testing.assert_array_equal(ig, ir)
    ag, Rg = pc.gravity_align(cloud, np.random.default_rng(4))
    ar, Rr = jpc.gravity_align(cloud, np.random.default_rng(4))
    np.testing.assert_allclose(Rg, Rr, atol=1e-6)
    np.testing.assert_allclose(ag, ar, atol=1e-5)


def test_dense_mapper_parity(rng, tmp_path):
    got = pc.DenseMapper(K_NP, voxel=0.1, stride=3, device="cpu")
    ref = jpc.DenseMapper(K_NP, voxel=0.1, stride=3)
    for _ in range(3):
        d, T = _depth(rng), _pose(rng)
        got.insert_keyframe(d, T)
        ref.insert_keyframe(jnp.asarray(d), jnp.asarray(T))
    a, b = got.global_cloud(), ref.global_cloud()
    assert a.shape == b.shape and len(a) > 100
    np.testing.assert_allclose(a, b, atol=1e-5)
    cloud = got.save(tmp_path / "dense.ply", tmp_path / "dense_occ.npz")
    np.testing.assert_array_equal(cloud, a)
    lines = (tmp_path / "dense.ply").read_text().splitlines()
    assert lines[2] == f"element vertex {len(a)}" and len(lines) == 7 + len(a)
    assert np.load(tmp_path / "dense_occ.npz")["occupied"].shape[1] == 3
    assert pc.DenseMapper(K_NP, device="cpu").global_cloud().shape == (0, 3)


def test_export_sparse_map_ply_equal(ring, tmp_path):
    arrays, jstate, tstate = ring
    pc.export_sparse_map_ply(tstate, tmp_path / "got.ply")
    jpc.export_sparse_map_ply(jstate, tmp_path / "ref.ply")
    assert (tmp_path / "got.ply").read_bytes() == (tmp_path / "ref.ply").read_bytes()
    assert f"element vertex {int(arrays['mp_valid'].sum())}" in (tmp_path / "got.ply").read_text()


def test_write_png_and_text_equal(rng, tmp_path):
    img = (rng.random((13, 17, 3)) * 255).astype(np.uint8)
    viz.write_png(tmp_path / "a.png", img)
    jviz.write_png(tmp_path / "b.png", img)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    a, b = np.zeros((20, 200, 3), np.uint8), np.zeros((20, 200, 3), np.uint8)
    np.testing.assert_array_equal(viz.draw_text(a, 2, 3, "KF:12 MP:3/4 ok-x?"),
                                  jviz.draw_text(b, 2, 3, "KF:12 MP:3/4 ok-x?"))


def test_draw_frame_equal(rng):
    gray = rng.random((60, 80)).astype(np.float32) * 300 - 20
    xy = rng.uniform(-5, 85, (40, 2)).astype(np.float32)
    tracked, valid = rng.random(40) < 0.5, rng.random(40) < 0.8
    np.testing.assert_array_equal(viz.draw_frame(gray, xy, tracked, valid, "OK", 3, 100),
                                  jviz.draw_frame(gray, xy, tracked, valid, "OK", 3, 100))


@pytest.mark.parametrize("axes, graph", [((0, 2), True), ((0, 1), False)])
def test_draw_map_equal(ring, axes, graph):
    arrays, jstate, tstate = ring
    pose = arrays["kf_pose"][5]
    got = viz.draw_map(tstate, size=300, axes=axes, cur_pose=torch.from_numpy(pose), draw_graph=graph, min_weight=5)
    ref = jviz.draw_map(jstate, size=300, axes=axes, cur_pose=pose, draw_graph=graph, min_weight=5)
    np.testing.assert_array_equal(got, ref)
    assert (got != 0).any()
    empty = map_state.empty_map(4, 16, 8, device="cpu")
    assert not viz.draw_map(empty, size=50).any()


def test_frame_recorder_files_equal(ring, rng, tmp_path):
    arrays, jstate, tstate = ring
    n = arrays["kf_xy"].shape[1]
    got = viz.FrameRecorder(tmp_path / "got", every=2, map_every=3)
    ref = jviz.FrameRecorder(tmp_path / "ref", every=2, map_every=3)
    for k in range(5):
        gray = (rng.random((240, 320)) * 255).astype(np.float32)
        fields = dict(xy=arrays["kf_xy"][k], mp=arrays["kf_mp"][k], kp_valid=arrays["kf_kp_valid"][k],
                      pose=arrays["kf_pose"][k])
        got.record(gray, SimpleNamespace(**{f: torch.from_numpy(v) for f, v in fields.items()}), tstate, "OK")
        ref.record(gray, SimpleNamespace(**{f: jnp.asarray(v) for f, v in fields.items()}), jstate, "OK")
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "got").iterdir())
    assert names == ["frame_00000.png", "frame_00002.png", "frame_00004.png", "map_00000.png", "map_00003.png"]
    for name in names:
        assert (tmp_path / "got" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes(), name
    assert n == 192
