"""Networked map streaming: the ROS pub/sub transport analog.

Port of the JAX package's `parallel/stream.py`. The reference streams every
map mutation from each SLAM client to a central server over ROS topics
(`KEYFRAME_<cid>` / `MAPPOINT_<cid>`, src/StreamThread.cc:13-16) and
broadcasts merged maps back on `CLIENT_MAP<cid>` (src/ros_server.cc:156-168).
Here the transport is the native length-prefixed TCP layer of
`native/runtime.cc`:

* `StreamClient` — the client side of `SendClassToServer`
  (src/StreamThread.cc:195-243). Deltas are encoded on the caller's thread
  (that reads the card, counted under the caller's role) and pushed on a
  native queue; a native worker only ships the bytes into the socket, so
  tracking never waits on the network.
* `OperatorClient` — the ServerViewer menu as a scriptable client.
* `MapServerNode` — the `server_node` process: accepts clients, applies
  their deltas to a `SlamServer`, answers map requests with a serialized
  (optionally merged) map the client loads. Each connection is served on a
  Python thread of its own, tagged "server" for the read and launch counts
  and run under the server's CUDA device; a merge runs there.

Wire format per message: u32-LE length prefix (transport) | u8 kind |
u32-LE cid | payload. Kinds: DELTA, GET_MAP, MAP, OK, OP, OP_REPLY, POLL.
Message limits are the reference's: 64 MB for a server receive and a
queued delta, 256 MB for a map reply, 16 MB for an operator reply.
"""

from __future__ import annotations

import contextlib
import io
import json
import struct
import threading
import time

import numpy as np
import torch

from .. import sync
from ..ops import prng
from ..runtime.native import NativeQueue, NativeWorker, TcpClient, TcpServer
from . import server as server_mod

KIND_DELTA = 0
KIND_GET_MAP = 1  # payload: u32 other_cid to merge with (0xFFFFFFFF = own map)
KIND_MAP = 2
KIND_OK = 3
# Operator surface (the ServerViewer menu, src/ServerViewer.cc:56-139): JSON
# commands list / reset / save / load / send, and the client's poll that
# stands in for the CLIENT_MAP<cid> subscription.
KIND_OP = 4
KIND_OP_REPLY = 5
KIND_POLL = 6

_HDR = struct.Struct("<BI")
NO_MERGE = 0xFFFFFFFF


def _pack(kind: int, cid: int, payload: bytes = b"") -> bytes:
    return _HDR.pack(kind, cid) + payload


def _unpack(msg: bytes):
    kind, cid = _HDR.unpack_from(msg)
    return kind, cid, msg[_HDR.size:]


class StreamClient:
    """The client's streaming thread (the SendClassToServer analog).

    `request_map()` is the synchronous map fetch (the CLIENT_MAP
    subscription, src/System.cc:996-1001); `poll_push()` asks for a map the
    operator staged."""

    def __init__(self, host: str, port: int, cid: int, queue_cap: int = 256):
        self.cid = cid
        self._conn = TcpClient(host, port)
        self._q = NativeQueue(queue_cap)
        self._lock = threading.Lock()  # the socket is shared with request_map
        self.n_queued = 0
        self.n_sent = 0
        self.bytes_sent = 0
        self.max_delta = 0

        def ship(msg: bytes) -> bool:
            with self._lock:
                self._conn.send(_pack(KIND_DELTA, self.cid, msg))
            self.n_sent += 1
            self.bytes_sent += len(msg)
            self.max_delta = max(self.max_delta, len(msg))
            return True

        self._worker = NativeWorker(self._q, ship, max_msg=1 << 26)

    @property
    def exception(self):
        """What the shipping worker raised, if anything."""
        return self._worker.exception

    # -- producer side --------------------------------------------------------
    def send_keyframe(self, state, kf_id: int):
        self.send_raw_delta(server_mod.encode_keyframe_delta(state, kf_id))

    def send_pose_update(self, state, kf_ids):
        self.send_raw_delta(server_mod.encode_pose_update(state, np.asarray(kf_ids)))

    def send_raw_delta(self, delta: bytes):
        self._q.push(delta)
        self.n_queued += 1

    # -- map fetch ------------------------------------------------------------
    def request_map(self, merge_with: int | None = None, timeout_ms: int = 60000) -> bytes:
        """The server's map for this client, merged with another client's
        session if asked, as bytes `serialization.load_map` reads. The
        delta queue is drained first."""
        self.flush()
        other = NO_MERGE if merge_with is None else merge_with
        with self._lock:
            self._conn.send(_pack(KIND_GET_MAP, self.cid, struct.pack("<I", other)))
            reply = self._conn.recv(timeout_ms=timeout_ms, max_len=1 << 28)
        kind, _, payload = _unpack(reply)
        if kind != KIND_MAP:
            raise OSError(f"unexpected reply kind {kind}")
        return payload

    def poll_push(self, timeout_ms: int = 10000) -> bytes | None:
        """A map the operator staged for this client (the Send button,
        src/ServerViewer.cc:132-137), or None."""
        with self._lock:
            self._conn.send(_pack(KIND_POLL, self.cid))
            reply = self._conn.recv(timeout_ms=timeout_ms, max_len=1 << 28)
        kind, _, payload = _unpack(reply)
        return payload if kind == KIND_MAP else None

    def flush(self, timeout_s: float = 30.0):
        """Wait until the delta queue is drained (the Shutdown barrier), at
        most timeout_s."""
        t0 = time.time()
        while len(self._q) > 0 and time.time() - t0 < timeout_s:
            time.sleep(0.002)

    def close(self):
        self.flush()
        self._q.close()
        try:
            self._worker.join()
        finally:
            self._conn.close()


class OperatorClient:
    """The operator's control connection (the ServerViewer menu,
    src/ServerViewer.cc:56-139, as a scriptable client)."""

    def __init__(self, host: str, port: int):
        self._conn = TcpClient(host, port)

    def command(self, op: dict, timeout_ms: int = 60000) -> dict:
        self._conn.send(_pack(KIND_OP, 0, json.dumps(op).encode()))
        reply = self._conn.recv(timeout_ms=timeout_ms, max_len=1 << 24)
        kind, _, payload = _unpack(reply)
        if kind != KIND_OP_REPLY:
            raise OSError(f"unexpected reply kind {kind}")
        return json.loads(payload.decode())

    def list_clients(self) -> dict:
        return self.command({"op": "list"})

    def reset(self, cid: int) -> dict:
        return self.command({"op": "reset", "cid": cid})

    def save(self, cid: int, path: str) -> dict:
        return self.command({"op": "save", "cid": cid, "path": path})

    def load(self, cid: int, path: str) -> dict:
        return self.command({"op": "load", "cid": cid, "path": path})

    def send_merge(self, cid: int, merge_with: int | None = None) -> dict:
        """Stage a (merged) map push for `cid`: the Send button."""
        op = {"op": "send", "cid": cid}
        if merge_with is not None:
            op["merge_with"] = merge_with
        return self.command(op)

    def close(self):
        self._conn.close()


class MapServerNode:
    """The server_node process: a TCP accept loop and one reader thread per
    connection feeding one `SlamServer` on `device` (None: the card)
    (src/ros_server.cc:201-210). `last_merge` holds the newest merge's wall
    time, outcome, inliers, fused points and reply bytes."""

    def __init__(self, port: int = 0, max_kf: int = 256, max_mp: int = 32768, n_kp: int = 1024, device=None):
        self.server = server_mod.SlamServer(max_kf, max_mp, n_kp, device=device)
        self.device = self.server.device
        self._listener = TcpServer(port)
        self.port = self._listener.port
        self._lock = threading.Lock()  # serializes SlamServer mutations
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._pending_push: dict[int, bytes] = {}
        self._K = torch.tensor([550.0, 550.0, 320.0, 240.0], dtype=torch.float32)
        self.n_deltas = 0
        self.last_merge = None
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn = self._listener.accept(timeout_ms=200)
            except TimeoutError:
                continue
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn):
        sync.set_role("server")
        ctx = torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()
        try:
            with ctx:
                while not self._stop.is_set():
                    try:
                        msg = conn.recv(timeout_ms=200, max_len=1 << 26)
                    except TimeoutError:
                        continue
                    kind, cid, payload = _unpack(msg)
                    if kind == KIND_DELTA:
                        with self._lock:
                            self.server.receive(cid, payload)
                            self.n_deltas += 1
                    elif kind == KIND_GET_MAP:
                        (other,) = struct.unpack("<I", payload)
                        conn.send(_pack(KIND_MAP, cid, self._map_bytes(cid, other)))
                    elif kind == KIND_POLL:
                        pushed = self._pending_push.pop(cid, None)
                        conn.send(_pack(KIND_MAP, cid, pushed) if pushed is not None else _pack(KIND_OK, cid))
                    elif kind == KIND_OP:
                        reply = self._handle_op(json.loads(payload.decode()))
                        conn.send(_pack(KIND_OP_REPLY, cid, json.dumps(reply).encode()))
        except OSError:
            pass  # the client went away
        finally:
            conn.close()

    # -- operator surface (the ServerViewer menu) -------------------------------
    def _handle_op(self, op: dict) -> dict:
        from ..utils import serialization

        kind = op.get("op")
        try:
            if kind == "list":
                with self._lock:
                    clients = {}
                    for cid, cm in self.server.clients.items():
                        n_kf, n_mp = sync.host(torch.stack([cm.state.n_kf, torch.sum(cm.state.mp_valid,
                                                                                       dtype=torch.int32)]))
                        clients[str(cid)] = {"kf": n_kf, "mp": n_mp, "deltas": cm.n_deltas}
                    return {"ok": True, "clients": clients}
            cid = int(op["cid"])
            if kind == "reset":
                # ServerViewer "Reset" (src/ServerViewer.cc:100-107).
                with self._lock:
                    self.server.clients.pop(cid, None)
                return {"ok": True}
            if kind == "save":
                with self._lock:
                    st = self.server.client_map(cid)
                    serialization.save_map(st, op["path"], metadata={"n_kf_host": sync.host(st.n_kf)})
                return {"ok": True, "path": op["path"]}
            if kind == "load":
                with self._lock:
                    state, _ = serialization.load_map(op["path"], device=self.device)
                    self.server._client(cid).state = state
                return {"ok": True}
            if kind == "send":
                # ServerViewer "Send": build the (optionally merged) map and
                # stage it for the client's next poll (src/ros_server.cc:119-168).
                other = int(op.get("merge_with", NO_MERGE))
                self._pending_push[cid] = self._map_bytes(cid, other)
                return {"ok": True, "bytes": len(self._pending_push[cid])}
            return {"ok": False, "error": f"unknown op {kind!r}"}
        except Exception as e:  # noqa: BLE001 — the operator gets the error text
            return {"ok": False, "error": str(e)}

    def _map_bytes(self, cid: int, other: int) -> bytes:
        """The client's map, merged with `other`'s when asked; a merge that
        finds no accepted pair answers the client's own map."""
        from ..utils import serialization

        with self._lock:
            if other != NO_MERGE:
                t0 = time.perf_counter()
                merged = self.server.merge_clients(cid, other, self._K, prng.key(0))
                self.last_merge = {"ms": (time.perf_counter() - t0) * 1e3, "accepted": merged is not None,
                                   "inliers": self.server.last_merge_inliers,
                                   "fused": self.server.last_merge_fused}
                state = merged if merged is not None else self.server.client_map(cid)
            else:
                state = self.server.client_map(cid)
            buf = io.BytesIO()
            serialization.save_map(state, buf, metadata={"n_kf_host": sync.host(state.n_kf), "ref_kf": 0,
                                                         "frame_id": 0})
            out = buf.getvalue()
            if other != NO_MERGE:
                self.last_merge["bytes"] = len(out)
            return out

    def set_intrinsics(self, K):
        """The merge's intrinsics (default fx=fy=550, cx=320, cy=240):
        clients stream undistorted pixels, so any consistent K works."""
        self._K = torch.as_tensor(K, dtype=torch.float32)

    def stop(self):
        self._stop.set()
        self._accept_thread.join(timeout=2)
        for t in self._threads:
            t.join(timeout=2)
        self._listener.close()
