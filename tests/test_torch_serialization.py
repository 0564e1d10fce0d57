"""Map save / load (`utils/serialization.py`, `SlamSystem.save_map` /
`load_map`) in both directions between the packages (CPU).

The format is the reference's npz: the port loads a file the JAX package
wrote and the JAX package loads one the port wrote, arrays exact (dtypes
included: uint32 descriptors on disk), metadata equal; the BoW database
rebuilt on load holds the same word lists (vectors within 1e-6, the
tolerance of `test_torch_slice.py`'s database parity); the version guard
raises as in `tests/test_serialization.py:29`; a snapshot without the newer
fields loads the same in both. Through `SlamSystem`: the saved arrays equal
`to_numpy` of the live map, a fresh system loads them, starts LOST and
tracks the next frame in the loaded map.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.models import map_state as jms
from orb_slam2v2_1_tpu.models import system as jsystem
from orb_slam2v2_1_tpu.ops import vocab as jvocab
from orb_slam2v2_1_tpu.utils import config as jconfig
from orb_slam2v2_1_tpu.utils import serialization as jser

from orb_slam2v2_1_tpu_torch.models import keyframe_database as kdb
from orb_slam2v2_1_tpu_torch.models import map_state, system
from orb_slam2v2_1_tpu_torch.ops import vocab
from orb_slam2v2_1_tpu_torch.utils import config, serialization, synthetic

torch.set_num_threads(2)

KW = dict(fx=275.0, fy=275.0, cx=160.0, cy=120.0, width=320, height=240, n_features=700,
          max_keyframes=16, max_map_points=4096, fps=3.0, bf=44.0, th_depth=40.0)


def _toy_map(rng, n_kp=64):
    """A JAX map of three keyframes with random descriptors and 16 points
    (`tests/test_serialization.py`'s, with more keypoints)."""
    state = jms.empty_map(8, 64, n_kp)
    for k in range(3):
        state, _ = jms.append_keyframe(
            state, jnp.eye(4).at[0, 3].set(float(k)), jnp.int32(k * 5),
            jnp.asarray(rng.uniform(0, 640, (n_kp, 2)).astype(np.float32)), jnp.zeros(n_kp, jnp.int32),
            jnp.zeros(n_kp), jnp.asarray(rng.integers(0, 2**32, (n_kp, 8), dtype=np.uint64).astype(np.uint32)),
            jnp.asarray(rng.uniform(size=n_kp) > 0.2), jnp.full(n_kp, -1.0), jnp.arange(n_kp, dtype=jnp.int32) % 16,
        )
    return state._replace(
        mp_pos=state.mp_pos.at[:16].set(jnp.asarray(rng.normal(0, 1, (16, 3)).astype(np.float32))),
        mp_valid=state.mp_valid.at[:16].set(True), n_mp=jnp.int32(16),
    )


def _jnp_arrays(state):
    return {n: np.asarray(v) for n, v in zip(jms.MapState._fields, state)}


def _assert_files_equal(a, b):
    da, db = np.load(a), np.load(b)
    assert sorted(da.files) == sorted(db.files)
    for k in da.files:
        assert da[k].dtype == db[k].dtype and da[k].shape == db[k].shape, k
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


@pytest.fixture(scope="module")
def vocs():
    npz = np.load(system.VOCAB_NPZ)
    return jvocab.load_vocabulary(npz), vocab.load_vocabulary(npz, device="cpu")


def test_port_loads_reference_file(tmp_path, rng, vocs):
    state = _toy_map(rng)
    path = tmp_path / "ref.npz"
    jser.save_map(state, path, metadata={"ref_kf": 2, "n_kf_host": 3, "frame_id": 14})
    got, meta = serialization.load_map(path, device="cpu")
    ref = _jnp_arrays(state)
    arrays = map_state.to_numpy(got)
    for k in ref:
        assert arrays[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(arrays[k], ref[k], err_msg=k)
    assert {k: int(v) for k, v in meta.items()} == {"ref_kf": 2, "n_kf_host": 3, "frame_id": 14}
    # Saving it again gives the reference's file back.
    serialization.save_map(got, tmp_path / "again.npz", metadata=meta)
    _assert_files_equal(path, tmp_path / "again.npz")
    # The BoW database rebuilt on load.
    jv, tv = vocs
    jdb = jser.rebuild_database(state, jv, 8, state.kf_desc.shape[1])
    tdb = kdb.database_to_numpy(serialization.rebuild_database(got, tv, 8, got.n_kp))
    np.testing.assert_array_equal(tdb["valid"], np.asarray(jdb.valid))
    np.testing.assert_array_equal(tdb["words"], np.asarray(jdb.words))
    np.testing.assert_allclose(tdb["vectors"], np.asarray(jdb.vectors), atol=1e-6)
    assert tdb["valid"].sum() == 3


def test_reference_loads_port_file(tmp_path, rng):
    tstate = map_state.from_numpy(_jnp_arrays(_toy_map(rng)), device="cpu")
    path = tmp_path / "port.npz"
    serialization.save_map(tstate, path, metadata={"ref_kf": 1, "n_kf_host": 3, "frame_id": 9})
    jstate, meta = jser.load_map(path)
    got = _jnp_arrays(jstate)
    for k, v in map_state.to_numpy(tstate).items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert {k: int(v) for k, v in meta.items()} == {"ref_kf": 1, "n_kf_host": 3, "frame_id": 9}
    jser.save_map(jstate, tmp_path / "ref.npz", metadata=meta)
    _assert_files_equal(path, tmp_path / "ref.npz")


def test_version_guard(tmp_path, rng):
    path = tmp_path / "map.npz"
    serialization.save_map(map_state.from_numpy(_jnp_arrays(_toy_map(rng)), device="cpu"), path)
    data = dict(np.load(path))
    data["format_version"] = np.int32(999)
    np.savez_compressed(path, **data)
    for load in (lambda: serialization.load_map(path, device="cpu"), lambda: jser.load_map(path)):
        with pytest.raises(ValueError, match="999"):
            load()


def test_older_snapshot_loads_alike(tmp_path, rng):
    """A file without `kf_seq`, `n_seq` and `covis`: both packages fill them
    alike (slot order, the keyframe count, the covisibility derived)."""
    path = tmp_path / "old.npz"
    jser.save_map(_toy_map(rng), path)
    data = {k: v for k, v in np.load(path).items() if k not in ("map_kf_seq", "map_n_seq", "map_covis")}
    np.savez_compressed(path, **data)
    jstate, _ = jser.load_map(path)
    tstate, _ = serialization.load_map(path, device="cpu")
    ref, got = _jnp_arrays(jstate), map_state.to_numpy(tstate)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["kf_seq"][:3].tolist() == [0, 1, 2] and int(got["n_seq"]) == 3 and got["covis"].any()


@pytest.fixture(scope="module")
def desk():
    cfg = config.SlamConfig(**KW)
    imgs, deps, gt = synthetic.desk_frames(cfg, synthetic.desk_trajectory(150)[:12], device="cpu")
    return cfg, imgs.numpy(), deps.numpy(), gt


def test_system_save_load_track(desk, tmp_path):
    """An async RGB-D run saves its map; the file holds `to_numpy` of the
    live map and the tracker's metadata. A fresh system (and the reference's)
    loads it and starts LOST; the port's tracks the next frame in the loaded
    map, within 2 cm of the ground truth."""
    cfg, imgs, deps, gt = desk
    path = tmp_path / "desk.npz"
    slam = system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, device="cpu", async_mapping=True)
    try:
        for i in range(10):
            slam.track_rgbd(imgs[i], deps[i], i * 0.1)
    finally:
        slam.shutdown()
    slam.save_map(path)
    data = np.load(path)
    for k, v in map_state.to_numpy(slam.map).items():
        np.testing.assert_array_equal(data[f"map_{k}"], v, err_msg=k)
    assert (int(data["meta_ref_kf"]), int(data["meta_n_kf_host"]), int(data["meta_frame_id"])) == (
        slam.ref_kf, slam.n_kf_host, 10)
    assert slam.n_kf_host >= 3

    fresh = system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, device="cpu", async_mapping=True)
    try:
        fresh.load_map(path)
        assert fresh.state == system.TrackState.LOST and fresh.n_kf_host == slam.n_kf_host
        assert fresh.frame_id == 10 and fresh.ref_kf == slam.ref_kf
        assert int(fresh.loop_closer.db.valid.sum()) == slam.n_kf_host
        out = fresh.track_rgbd(imgs[11], deps[11], 1.1)
        assert out is not None and fresh.state == system.TrackState.OK
        c_est, c_gt = (-T[:3, :3].T @ T[:3, 3] for T in (np.asarray(out, np.float64), gt[11]))
        assert np.linalg.norm(c_est - c_gt) < 0.02
    finally:
        fresh.shutdown()

    jslam = jsystem.SlamSystem(config=jconfig.SlamConfig(**KW), sensor=jsystem.Sensor.RGBD)
    jslam.load_map(path)
    assert jslam.state == jsystem.TrackState.LOST and jslam.n_kf_host == slam.n_kf_host
    assert int(np.asarray(jslam.loop_closer.db.valid).sum()) == slam.n_kf_host
