"""The multi-session map server on both packages (CPU, loopback TCP).

- Deltas: keyframe, pose-update and erase deltas encoded by either package
  decode in the other's `SlamServer` to the same client map, field for
  field (the npz wire format is the reference's: same names and dtypes).
- `merge_clients` on two sessions of a shared scene built by the reference
  (`tests/test_server.py`'s `_session_map`), with the reference's Sim3
  hypothesis sets injected into the port and with the port's own draws
  from the same key: the same merged map (every
  integer field exact, poses and points within 2 mm / 0.05 deg) and the same
  `last_merge_fused`; the capacity guard raises in both.
- `MapServerNode` with port clients on loopback: the cases of
  `tests/test_stream.py` (streaming, a merged fetch, the operator session)
  and the TCP half of `tests/test_multiprocess.py` (a client in another
  process); `SlamSystem.connect_server` / `fetch_server_map` leave the client
  LOST in the merged map. Every wait is bounded: each receive has its
  timeout and each poll loop a deadline; every node is stopped in a
  `finally`.
"""

import io
import os
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_server import K, _session_map
from test_torch_loop import _reference_sets

from orb_slam2v2_1_tpu.models.map_state import MapState as JMapState
from orb_slam2v2_1_tpu.ops import lie as jlie
from orb_slam2v2_1_tpu.parallel import server as jsrv

from orb_slam2v2_1_tpu_torch.models import map_state
from orb_slam2v2_1_tpu_torch.parallel import server as srv
from orb_slam2v2_1_tpu_torch.parallel.stream import MapServerNode, OperatorClient, StreamClient
from orb_slam2v2_1_tpu_torch.utils import serialization

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (16, 512, 64)
T_OFFSET = np.asarray(jlie.se3_exp(jnp.asarray([0.4, -0.2, 0.1, 0.05, 0.1, -0.03], jnp.float32))).astype(np.float32)


def _np(jstate):
    return {name: np.asarray(v) for name, v in zip(JMapState._fields, jstate)}


def _port(jstate):
    return map_state.from_numpy(_np(jstate), device="cpu")


def _two_sessions(rng):
    shared = rng.integers(0, 2**32, (64, 8), dtype=np.uint64).astype(np.uint32)
    map_a, pts_w, _ = _session_map(rng, np.eye(4, dtype=np.float32), seed_desc=shared)
    map_b, _, _ = _session_map(rng, T_OFFSET, seed_desc=shared, shared_pts=pts_w)
    return map_a, map_b


def _wait(cond, timeout_s=20.0):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout_s:
            raise TimeoutError("condition not met in time")
        time.sleep(0.01)


def _assert_maps_equal(got: dict, ref: dict):
    for name in JMapState._fields:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


# ---------------------------------------------------------------------------
# Deltas across packages
# ---------------------------------------------------------------------------


def test_deltas_decode_in_either_server(rng):
    jmap, _ = _two_sessions(rng)
    tmap = _port(jmap)
    deltas = {
        "ref": [jsrv.encode_keyframe_delta(jmap, k) for k in range(3)]
        + [jsrv.encode_pose_update(jmap, np.array([0, 2])), jsrv.encode_keyframe_delta(jmap, 1, jsrv.ERASE)],
        "port": [srv.encode_keyframe_delta(tmap, k) for k in range(3)]
        + [srv.encode_pose_update(tmap, np.array([0, 2])), srv.encode_keyframe_delta(tmap, 1, srv.ERASE)],
    }
    for a, b in zip(deltas["ref"], deltas["port"]):
        za, zb = np.load(io.BytesIO(a)), np.load(io.BytesIO(b))
        assert za.files == zb.files
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    mirrors = {}
    for enc, ds in deltas.items():
        js, ts = jsrv.SlamServer(*DIMS), srv.SlamServer(*DIMS, device="cpu")
        for d in ds:
            js.receive(5, d)
            ts.receive(5, d)
        mirrors[("ref", enc)] = _np(js.client_map(5))
        mirrors[("port", enc)] = map_state.to_numpy(ts.client_map(5))
        assert ts.clients[5].n_deltas == js.clients[5].n_deltas == 5
    base = mirrors[("ref", "ref")]
    assert int(base["n_kf"]) == 3 and not base["kf_valid"][1] and base["kf_valid"][2]
    for key, m in mirrors.items():
        _assert_maps_equal(m, base)


# ---------------------------------------------------------------------------
# Cross-session merge
# ---------------------------------------------------------------------------


def _servers_with_sessions(rng, dims=DIMS):
    map_a, map_b = _two_sessions(rng)
    js, ts = jsrv.SlamServer(*dims), srv.SlamServer(*dims, device="cpu")
    for cid, m in ((1, map_a), (2, map_b)):
        for k in range(3):
            d = jsrv.encode_keyframe_delta(m, k)
            js.receive(cid, d)
            ts.receive(cid, d)
    return js, ts


@pytest.mark.parametrize("joint", [True, False])
def test_merge_clients_parity(rng, joint):
    js, ts = _servers_with_sessions(rng)
    key = jax.random.key(0)
    ref = js.merge_clients(1, 2, K, key, joint_optimize=joint)
    got = ts.merge_clients(1, 2, torch.from_numpy(np.array(K)), joint_optimize=joint,
                           sim3_sets=lambda valid: torch.from_numpy(_reference_sets(key, valid.numpy())))
    _assert_merged_alike(ref, got, joint, ts, js)


def test_merge_clients_parity_own_draws(rng):
    """The same merge without injected sets: the port draws every pair's
    sets from its default key, `prng.key(0)`, the reference's `key(0)`."""
    js, ts = _servers_with_sessions(rng)
    ref = js.merge_clients(1, 2, K, jax.random.key(0))
    got = ts.merge_clients(1, 2, torch.from_numpy(np.array(K)))
    _assert_merged_alike(ref, got, True, ts, js)


def _assert_merged_alike(ref, got, joint, ts, js):
    assert ref is not None and got is not None
    r, g = _np(ref), map_state.to_numpy(got)
    assert int(g["n_kf"]) == int(r["n_kf"]) == 6
    for name in JMapState._fields:
        if r[name].dtype.kind in "biu":
            np.testing.assert_array_equal(g[name], r[name], err_msg=name)
    np.testing.assert_allclose(g["mp_pos"], r["mp_pos"], atol=2e-3)
    np.testing.assert_allclose(g["mp_normal"], r["mp_normal"], atol=1e-3)
    c_g = np.einsum("kji,kj->ki", g["kf_pose"][:, :3, :3], -g["kf_pose"][:, :3, 3])
    c_r = np.einsum("kji,kj->ki", r["kf_pose"][:, :3, :3], -r["kf_pose"][:, :3, 3])
    assert np.abs(c_g - c_r).max() <= 2e-3
    rel = np.einsum("kji,kjl->kil", g["kf_pose"][:6, :3, :3].astype(np.float64), r["kf_pose"][:6, :3, :3])
    assert np.degrees(np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1))).max() <= 0.05
    if joint:
        assert ts.last_merge_fused == js.last_merge_fused > 0
        assert ts.last_merge_inliers >= 20
    # Session B's points land on A's within the noise of the solve.
    np.testing.assert_allclose(g["mp_pos"][64:128], g["mp_pos"][:64], atol=2e-2)


def test_merge_with_generator_and_capacity_guard(rng):
    """The default key merges, and again on the same server with the
    same result (the port's maps are updated out of place; the reference's
    merge donates buffers of its first session's map, and a second merge on
    its server fails). An empty session merges nothing; past capacity both
    raise."""
    js, ts = _servers_with_sessions(rng)
    got = ts.merge_clients(1, 2, torch.from_numpy(np.array(K)))  # the default key
    assert got is not None and int(got.n_kf) == 6
    again = ts.merge_clients(1, 2, torch.from_numpy(np.array(K)))
    for a, b in zip(map_state.to_numpy(got).values(), map_state.to_numpy(again).values()):
        np.testing.assert_array_equal(a, b)
    assert ts.merge_clients(1, 9, torch.from_numpy(np.array(K))) is None  # an empty session
    js, ts = _servers_with_sessions(rng, dims=(5, 512, 64))
    with pytest.raises(ValueError, match="capacity"):
        js.merge_clients(1, 2, K, jax.random.key(0))
    with pytest.raises(ValueError, match="capacity"):
        ts.merge_clients(1, 2, torch.from_numpy(np.array(K)))


def test_delta_stream_in_process(rng):
    jmap, _ = _two_sessions(rng)
    tmap = _port(jmap)
    ts = srv.SlamServer(*DIMS, device="cpu")
    stream = srv.DeltaStream(ts, 3)
    stream.flush(tmap, 3)
    stream.flush(tmap, 3)  # nothing new: one pose update only
    assert ts.clients[3].n_deltas == 5
    _assert_maps_equal(map_state.to_numpy(ts.client_map(3)), map_state.to_numpy(
        _mirror_of(tmap)))


def _mirror_of(tmap):
    s = srv.SlamServer(*DIMS, device="cpu")
    for k in range(3):
        s.receive(0, srv.encode_keyframe_delta(tmap, k))
    s.receive(0, srv.encode_pose_update(tmap, np.arange(3)))
    return s.client_map(0)


# ---------------------------------------------------------------------------
# Loopback node with port clients
# ---------------------------------------------------------------------------


@pytest.fixture
def node():
    n = MapServerNode(port=0, max_kf=DIMS[0], max_mp=DIMS[1], n_kp=DIMS[2], device="cpu")
    n.set_intrinsics(np.asarray(K))
    try:
        yield n
    finally:
        n.stop()


def test_client_streams_keyframes_to_server(rng, node):
    jmap, _ = _two_sessions(rng)
    state = _port(jmap)
    client = StreamClient("127.0.0.1", node.port, cid=1)
    try:
        for k in range(3):
            client.send_keyframe(state, k)
        client.send_pose_update(state, np.array([0, 1, 2]))
        client.flush()
        _wait(lambda: node.n_deltas >= 4)
    finally:
        client.close()
    assert client.exception is None and client.n_sent == 4 and client.max_delta > 0
    mirror = node.server.client_map(1)
    assert int(mirror.n_kf) == 3
    np.testing.assert_allclose(mirror.kf_pose[:3].numpy(), np.asarray(jmap.kf_pose[:3]), atol=1e-6)


def test_fetch_merged_map_over_tcp(rng, node):
    map_a, map_b = (_port(m) for m in _two_sessions(rng))
    ca = StreamClient("127.0.0.1", node.port, cid=1)
    cb = StreamClient("127.0.0.1", node.port, cid=2)
    try:
        for k in range(3):
            ca.send_keyframe(map_a, k)
            cb.send_keyframe(map_b, k)
        cb.flush()
        _wait(lambda: node.n_deltas >= 6)
        payload = ca.request_map(merge_with=2, timeout_ms=60000)
        own = ca.request_map(timeout_ms=60000)
    finally:
        ca.close()
        cb.close()
    merged, meta = serialization.load_map(io.BytesIO(payload), device="cpu")
    assert int(merged.n_kf) == 6 and int(meta["n_kf_host"]) == 6
    np.testing.assert_allclose(merged.mp_pos[64:128].numpy(), merged.mp_pos[:64].numpy(), atol=2e-2)
    assert node.last_merge["accepted"] and node.last_merge["fused"] > 0 and node.last_merge["bytes"] == len(payload)
    assert int(serialization.load_map(io.BytesIO(own), device="cpu")[0].n_kf) == 3


def test_operator_session(rng, node, tmp_path):
    map_a, map_b = (_port(m) for m in _two_sessions(rng))
    ca = StreamClient("127.0.0.1", node.port, cid=1)
    cb = StreamClient("127.0.0.1", node.port, cid=2)
    op = OperatorClient("127.0.0.1", node.port)
    try:
        for k in range(3):
            ca.send_keyframe(map_a, k)
            cb.send_keyframe(map_b, k)
        ca.flush()
        cb.flush()
        _wait(lambda: node.n_deltas >= 6)
        out = op.list_clients()
        assert out["ok"] and set(out["clients"]) == {"1", "2"} and out["clients"]["1"]["kf"] == 3
        path = str(tmp_path / "client1.npz")
        assert op.save(1, path)["ok"]
        assert int(serialization.load_map(path, device="cpu")[0].n_kf) == 3
        assert ca.poll_push() is None
        out = op.send_merge(1, merge_with=2)
        assert out["ok"] and out["bytes"] > 0
        payload = ca.poll_push()
        assert payload is not None and int(serialization.load_map(io.BytesIO(payload), device="cpu")[0].n_kf) == 6
        assert ca.poll_push() is None  # the push is one-shot
        assert op.reset(2)["ok"] and "2" not in op.list_clients()["clients"]
        assert op.load(3, path)["ok"] and op.list_clients()["clients"]["3"]["kf"] == 3
        bad = op.command({"op": "nope", "cid": 1})
        assert not bad["ok"] and "unknown op" in bad["error"]
    finally:
        op.close()
        ca.close()
        cb.close()


CLIENT_PROCESS = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from orb_slam2v2_1_tpu_torch.models.map_state import append_keyframe, empty_map
from orb_slam2v2_1_tpu_torch.parallel.stream import StreamClient

st = empty_map(8, 256, 64, device="cpu")
r2 = np.random.default_rng(3)
for k in range(2):
    st, _ = append_keyframe(
        st, torch.eye(4), k, torch.from_numpy(r2.uniform(30, 600, (64, 2)).astype(np.float32)),
        torch.zeros(64, dtype=torch.int32), torch.zeros(64), torch.from_numpy(
            r2.integers(0, 2**31, (64, 8), dtype=np.int64).astype(np.int32)),
        torch.ones(64, dtype=torch.bool), torch.full((64,), -1.0), torch.full((64,), -1, dtype=torch.int32))
client = StreamClient("127.0.0.1", {port}, cid=7)
for k in range(2):
    client.send_keyframe(st, k)
client.close()
print("sent", client.n_sent)
"""


def test_client_in_another_process(node):
    proc = subprocess.run([sys.executable, "-c", CLIENT_PROCESS.format(root=ROOT, port=node.port)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "sent 2" in proc.stdout
    _wait(lambda: node.n_deltas >= 2)
    assert int(node.server.client_map(7).n_kf) == 2


def test_slam_system_fetches_merged_map_and_is_lost(rng, node):
    """Two sessions on the node; a `SlamSystem` connected as session 1
    fetches the map merged with session 2 and starts LOST in it."""
    from orb_slam2v2_1_tpu_torch.models import system
    from orb_slam2v2_1_tpu_torch.utils import config

    map_a, map_b = (_port(m) for m in _two_sessions(rng))
    cfg = config.SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=DIMS[2], max_keyframes=DIMS[0],
                            max_map_points=DIMS[1])
    slam = system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, device="cpu")
    cb = StreamClient("127.0.0.1", node.port, cid=2)
    try:
        slam.connect_server("127.0.0.1", node.port, 1)
        slam.map = map_a
        for k in range(3):
            slam.ref_kf = k
            slam._stream_keyframe()
            cb.send_keyframe(map_b, k)
        cb.flush()
        _wait(lambda: node.n_deltas >= 9)  # 3 keyframes and 3 pose updates of session 1, 3 of session 2
        assert slam.poll_server_push() is False
        slam.state = system.TrackState.OK
        slam.fetch_server_map(merge_with=2)
        assert slam.state == system.TrackState.LOST and slam.last_frame is None
        assert slam.n_kf_host == 6 and int(slam.map.n_kf) == 6
        assert slam.loop_closer.db.vectors.shape[0] == DIMS[0]
        assert slam._stream.exception is None
    finally:
        cb.close()
        slam.shutdown()
    assert slam._stream is None
