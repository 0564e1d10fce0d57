"""ctypes bindings for the native runtime (`native/runtime.cc`).

The port's own loader of the C++ source the JAX package also uses: bounded
byte-message queues, atomic flags and worker threads that wait on a queue in
native code with the GIL released, so the mapping and loop-closing workers
overlap the tracking thread (the reference's std::thread pipeline,
src/System.cc:124-143), and the length-prefixed TCP transport the map
server streams over (`TcpServer`, `TcpConn`, `TcpClient`).

The library is built at first use with g++ into `build/torch_runtime/` at the
repository root, under a name keyed on the source's content, through a temp
file renamed into place, so concurrent builds (test workers) never see a
partial file. It is never written next to the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import socket
import subprocess
import tempfile
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = ROOT / "native" / "runtime.cc"
BUILD_DIR = ROOT / "build" / "torch_runtime"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

_build_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liborbslam_rt_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the runtime unless its content-keyed library exists; returns
    the library's path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _declare(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rt_now_ns.restype = ctypes.c_uint64
    lib.rt_now_ns.argtypes = []
    lib.rtq_new.restype = P
    lib.rtq_new.argtypes = [I]
    lib.rtq_push.restype = I
    lib.rtq_push.argtypes = [P, ctypes.c_char_p, I, I]
    lib.rtq_pop.restype = I
    lib.rtq_pop.argtypes = [P, ctypes.c_char_p, I, I]
    lib.rtq_size.restype = I
    lib.rtq_size.argtypes = [P]
    for name in ("rtq_clear", "rtq_close", "rtq_free"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [P]
    lib.rtf_new.restype = P
    lib.rtf_new.argtypes = []
    lib.rtf_set.restype = None
    lib.rtf_set.argtypes = [P, I]
    lib.rtf_get.restype = I
    lib.rtf_get.argtypes = [P]
    lib.rtf_exchange.restype = I
    lib.rtf_exchange.argtypes = [P, I]
    lib.rtf_free.restype = None
    lib.rtf_free.argtypes = [P]
    lib.rtw_start.restype = P
    lib.rtw_start.argtypes = [P, P, P, I]
    lib.rtw_done.restype = I
    lib.rtw_done.argtypes = [P]
    for name in ("rtw_join", "rtw_free"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [P]
    for name, args in (("rt_listen", [I]), ("rt_port", [I]), ("rt_accept", [I, I]),
                       ("rt_connect", [ctypes.c_char_p, I]), ("rt_send_msg", [I, ctypes.c_char_p, I]),
                       ("rt_recv_msg", [I, ctypes.c_char_p, I, I])):
        getattr(lib, name).restype = I
        getattr(lib, name).argtypes = args
    lib.rt_close_fd.restype = None
    lib.rt_close_fd.argtypes = [I]


def load():
    """The runtime library, built on first use."""
    global _lib
    if _lib is None:
        with _build_lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                _declare(lib)
                _lib = lib
    return _lib


def now_ns() -> int:
    """The steady clock in nanoseconds."""
    return int(load().rt_now_ns())


class NativeQueue:
    """Bounded MPMC byte-message queue (the InsertKeyFrame queue analog)."""

    def __init__(self, capacity: int = 64):
        self._lib = load()
        self._q = self._lib.rtq_new(capacity)

    def push(self, msg: bytes, timeout_ms: int = -1) -> bool:
        """Append `msg`, waiting while the queue is full (forever with
        timeout_ms < 0). False on timeout or when the queue is closed."""
        return self._lib.rtq_push(self._q, msg, len(msg), timeout_ms) == 0

    def pop(self, timeout_ms: int = -1, max_len: int = 1 << 20):
        """The oldest message; None on timeout; EOFError once closed and
        drained."""
        buf = ctypes.create_string_buffer(max_len)
        n = self._lib.rtq_pop(self._q, buf, max_len, timeout_ms)
        if n == -1:
            return None
        if n == -2:
            raise EOFError("queue closed")
        return buf.raw[: min(n, max_len)]

    def __len__(self):
        return self._lib.rtq_size(self._q)

    def clear(self):
        self._lib.rtq_clear(self._q)

    def close(self):
        """Refuse further pushes; pops drain what is left, then raise."""
        self._lib.rtq_close(self._q)

    def free(self):
        if self._q:
            self._lib.rtq_free(self._q)
            self._q = None


class NativeFlag:
    """Atomic int flag (the mbAbortBA / mbStopGBA analog)."""

    def __init__(self, value: int = 0):
        self._lib = load()
        self._f = self._lib.rtf_new()
        if value:
            self.set(value)

    def set(self, v: int = 1):
        self._lib.rtf_set(self._f, v)

    def clear(self):
        self._lib.rtf_set(self._f, 0)

    def get(self) -> int:
        return self._lib.rtf_get(self._f)

    def exchange(self, v: int) -> int:
        """Store v; returns the previous value."""
        return self._lib.rtf_exchange(self._f, v)

    def __bool__(self):
        return self.get() != 0

    def free(self):
        if self._f:
            self._lib.rtf_free(self._f)
            self._f = None


_CALLBACK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int)


class NativeWorker:
    """Native thread draining a NativeQueue into a Python callback.

    The wait for a message happens in C++ off the GIL; `fn(msg)` runs under
    the GIL (PyTorch releases it again inside its kernels). The worker stops
    when the queue is closed and drained, when `fn` returns False, or when
    `fn` raises: the exception is kept in `exception` (it never unwinds into
    C) and raised by `join`."""

    def __init__(self, queue: NativeQueue, fn, max_msg: int = 1 << 20):
        self._lib = load()
        self.queue = queue
        self.exception = None

        def trampoline(_ctx, data, n):
            try:
                keep = fn(bytes(bytearray(data[:n])))
                return 0 if keep is not False else -1
            except BaseException as exc:  # noqa: BLE001 — kept for join(); must not unwind into C
                self.exception = exc
                return -1

        # The C side holds this pointer for the thread's life: keep the
        # ctypes object referenced as long as the worker.
        self._cb = _CALLBACK(trampoline)
        self._w = self._lib.rtw_start(queue._q, ctypes.cast(self._cb, ctypes.c_void_p), None, max_msg)

    def done(self) -> bool:
        return bool(self._lib.rtw_done(self._w))

    def join(self):
        """Wait for the thread (close its queue first); raises the callback's
        exception, if any."""
        self._lib.rtw_join(self._w)
        if self.exception is not None:
            raise self.exception

    def free(self):
        if self._w:
            self._lib.rtw_free(self._w)
            self._w = None


class TcpServer:
    """A listening socket for length-prefixed messages (port 0: any free
    port, read back in `port`)."""

    def __init__(self, port: int = 0):
        self._lib = load()
        self._fd = self._lib.rt_listen(port)
        if self._fd < 0:
            raise OSError(f"rt_listen({port}) failed")
        self.port = self._lib.rt_port(self._fd)

    def accept(self, timeout_ms: int = 5000):
        """The next connection; TimeoutError when none came in time."""
        fd = self._lib.rt_accept(self._fd, timeout_ms)
        if fd < 0:
            raise TimeoutError("rt_accept timed out")
        return TcpConn(self._lib, fd)

    def close(self):
        if self._fd >= 0:
            self._lib.rt_close_fd(self._fd)
            self._fd = -1


class TcpConn:
    """One connection: whole messages, a u32-LE length prefix each.

    `rt_recv_msg` answers -1 both when the wait timed out and when the peer
    closed the connection; a non-blocking peek on a duplicate of the socket
    tells the two apart, so a closed peer raises OSError (ending a server's
    reader) and only a quiet one raises TimeoutError. The receive buffer is
    kept between calls and grown to the largest `max_len` asked for."""

    def __init__(self, lib_, fd: int):
        self._lib = lib_
        self._fd = fd
        self._peek = socket.socket(fileno=os.dup(fd))
        self._buf = None

    def send(self, msg: bytes):
        if self._lib.rt_send_msg(self._fd, msg, len(msg)) < 0:
            raise OSError("rt_send_msg failed")

    def _closed_by_peer(self) -> bool:
        try:
            return self._peek.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT) == b""
        except BlockingIOError:
            return False
        except OSError:
            return True

    def recv(self, timeout_ms: int = 5000, max_len: int = 1 << 24) -> bytes:
        """The next message, at most max_len bytes (OSError if longer)."""
        if self._buf is None or len(self._buf) < max_len:
            self._buf = ctypes.create_string_buffer(max_len)
        n = self._lib.rt_recv_msg(self._fd, self._buf, max_len, timeout_ms)
        if n == -1:
            if self._closed_by_peer():
                raise OSError("connection closed by the peer")
            raise TimeoutError("rt_recv_msg timed out")
        if n == -3:
            raise OSError("message larger than max_len")
        return self._buf.raw[:n]

    def close(self):
        if self._fd >= 0:
            self._peek.close()
            self._lib.rt_close_fd(self._fd)
            self._fd = -1


class TcpClient(TcpConn):
    """A connection to `host:port` (OSError when refused)."""

    def __init__(self, host: str, port: int):
        lib_ = load()
        fd = lib_.rt_connect(host.encode(), port)
        if fd < 0:
            raise OSError(f"rt_connect({host}, {port}) failed")
        super().__init__(lib_, fd)
