"""Async SLAM pipeline: native worker threads + versioned map snapshots.

Port of the JAX package's `runtime/pipeline.py`. The reference runs Tracking
in the caller's thread and LocalMapping / LoopClosing as std::threads sharing
one pointer-graph map under mutexes (src/System.cc:124-143). Here the shared
state is a `MapState` of tensors in a versioned `MapBox`; workers compute on
snapshots and publish new versions, and the tracking thread's advisory
updates (visibility statistics) publish only if nobody else published first.
Every map update is out of place, so a snapshot stays valid for whoever
holds it; the box's lock is held for the swap of a reference only.

Streams: every thread launches on `torch.cuda.current_stream(device)`, which
on a thread that never chose a stream is the card's default stream. So the
tracker's and the workers' kernels run in the order the host submits them,
and a snapshot read from the box needs no event: the kernels that wrote it
were submitted before the publish that made it visible. A side stream for
the workers (with `record_stream` and events at `publish` / `read`) would let
their kernels overlap the tracker's; that is later work. A native thread
starts on device 0 whatever the tracker's device is, so each worker body
runs under `torch.cuda.device(device)`.

Cooperative cancellation mirrors `mbAbortBA` (src/LocalMapping.cc:126): when
tracking enqueues a new keyframe while the mapping worker is busy, the worker
skips the local-BA stage of the round it starts next and catches up.

A thread that waits for the structural lock reports the wait to the wait
clock of `spans`, and so does the tracker while the mapping queue is full.
Each keyframe's time in the mapping queue is a span `map_queue` of the
mapper's recorder, from its submit to the start of its round.
"""

from __future__ import annotations

import contextlib
import struct
import threading
from time import perf_counter_ns

import torch

from .. import spans, sync
from .native import NativeFlag, NativeQueue, NativeWorker

# How long a blocked push waits before it looks for a failed worker again.
_PUSH_POLL_MS = 100


class MapBox:
    """Versioned published snapshot of the map state.

    Two writer classes, mirroring the reference's mutex split
    (Map::mMutexMap vs mMutexMapUpdate, include/Map.h):

    * **structural** writers (keyframe append, mapping round, loop
      correction, global-BA merge) serialize on `mutate()`: read, compute and
      publish under the structural lock, so no structural update is lost;
    * **advisory** writers (tracking's per-frame visibility statistics) use
      `publish(expected_version=...)` and lose the race if anything was
      published in between: the statistics are counters whose occasional
      loss is harmless (the reference's unlocked Increase{Visible,Found}).
    """

    def __init__(self, state):
        self._lock = threading.Lock()
        self._struct_lock = threading.Lock()
        self._state = state
        self._version = 0

    def read(self):
        """(state, version) of the newest publish."""
        with self._lock:
            return self._state, self._version

    def publish(self, state, expected_version=None) -> bool:
        """Swap in a new state. With expected_version, only if nobody
        published since that version; returns whether it was published."""
        with self._lock:
            if expected_version is not None and self._version != expected_version:
                return False
            self._state = state
            self._version += 1
            return True

    def mutate(self, fn):
        """Serialized structural read-modify-publish: fn(state) -> new state
        (only the state; other results leave through closures). The
        structural lock is held across the work: structural writers come at
        keyframe cadence and must not overwrite each other."""
        lock = self._struct_lock
        if not lock.acquire(blocking=False):
            t0 = perf_counter_ns()
            lock.acquire()
            spans.waited(spans.MAP, t0)
        try:
            state, _ = self.read()
            new_state = fn(state)
            self.publish(new_state)
            return new_state
        finally:
            lock.release()

    @property
    def version(self):
        with self._lock:
            return self._version


class AsyncMapper:
    """Local-mapping and loop-closing workers behind native queues.

    mapping_fn(state, kf_id, allow_ba) -> state, run under the structural lock.
    loop_fn(snapshot, kf_id) -> None | (state -> state), optional: detection
      runs lock-free on a snapshot; a non-None return is the closure, run
      under the structural lock.
    loop_service_fn(), optional: after each loop round, outside the lock (the
      detached global BA's start / abort / merge).
    join_fn(snapshot, kf_before, kf_reloc), optional: like loop_fn for a
      candidate pair the tracker found by relocalization (`submit_join`).

    `device`: the CUDA device the workers launch on (None: no device
    context, as on the CPU). `recorder`: the `spans.Recorder` bound to both
    workers, which also takes the `map_queue` spans (a new one if None)."""

    def __init__(self, box: MapBox, mapping_fn, loop_fn=None, queue_cap: int = 32,
                 loop_service_fn=None, device=None, join_fn=None, recorder=None):
        self.box = box
        self.recorder = spans.Recorder() if recorder is None else recorder
        self._queued = {}  # kf_id -> perf_counter_ns() of its submit
        self._join_fn = join_fn
        self._mapping_fn = mapping_fn
        self._loop_fn = loop_fn
        self._loop_service_fn = loop_service_fn
        self._device = device if device is not None and torch.device(device).type == "cuda" else None
        self.abort_ba = NativeFlag()
        self.map_q = NativeQueue(queue_cap)
        self.loop_q = NativeQueue(queue_cap) if loop_fn else None
        self.n_submitted = 0
        self.n_processed = 0
        self.n_ba_skipped = 0
        self.n_loop_rounds = 0
        self.n_loops = 0
        self._map_worker = NativeWorker(self.map_q, self._guard("mapping", self._map_step))
        self._loop_worker = NativeWorker(self.loop_q, self._guard("loop", self._loop_step)) if loop_fn else None

    def _guard(self, role: str, step):
        """The worker body: tagged with its thread role for the counters,
        under the device context."""

        def body(msg: bytes):
            sync.set_role(role)
            ctx = torch.cuda.device(self._device) if self._device is not None else contextlib.nullcontext()
            with ctx, spans.bind(self.recorder):
                return step(msg)

        return body

    # -- tracking side ------------------------------------------------------
    def submit_keyframe(self, kf_id: int):
        """Queue mapping work for a just-appended keyframe and interrupt any
        local BA about to start (LocalMapping::InsertKeyFrame + mbAbortBA).
        While the queue is full the wait is cut into short pushes, between
        which a failed worker's exception is raised here."""
        self.raise_worker_errors()
        self.abort_ba.set(1)
        msg = struct.pack("<i", kf_id)
        self._queued[kf_id] = t0 = perf_counter_ns()
        if not self.map_q.push(msg, timeout_ms=0):
            while not self.map_q.push(msg, timeout_ms=_PUSH_POLL_MS):
                self.raise_worker_errors()
            spans.waited(spans.MAP, t0)
        self.n_submitted += 1

    def submit_join(self, kf_before: int, kf_reloc: int):
        """Queue a loop round on a candidate pair for the loop worker, behind
        the rounds already queued."""
        if self.loop_q is None or self._join_fn is None:
            return
        self.raise_worker_errors()
        msg = struct.pack("<ii", kf_before, kf_reloc)
        while not self.loop_q.push(msg, timeout_ms=_PUSH_POLL_MS):
            self.raise_worker_errors()

    # -- worker side --------------------------------------------------------
    def _map_step(self, msg: bytes):
        (kf_id,) = struct.unpack("<i", msg)
        queued = self._queued.pop(kf_id, None)
        if queued is not None:
            now = perf_counter_ns()
            self.recorder.add("map_queue", kf_id, None, queued, now, (now - queued) * 1e-6)
        self.abort_ba.clear()
        # Skip BA when a newer keyframe is already waiting (interrupted-BA
        # semantics); the culling, triangulation and fusion stages always run.
        allow_ba = len(self.map_q) == 0 and not self.abort_ba
        self.box.mutate(lambda state: self._mapping_fn(state, kf_id, allow_ba))
        if not allow_ba:
            self.n_ba_skipped += 1
        self.n_processed += 1
        if self.loop_q is not None:
            # A loop worker that died keeps its error for the tracker; its
            # queue then takes no more rounds.
            while not self.loop_q.push(msg, timeout_ms=_PUSH_POLL_MS):
                if self._loop_worker.done():
                    break

    def _loop_step(self, msg: bytes):
        if len(msg) == 8:  # a pair from submit_join
            snapshot, _ = self.box.read()
            apply_fn = self._join_fn(snapshot, *struct.unpack("<ii", msg))
            if apply_fn is not None:
                self.box.mutate(apply_fn)
                self.n_loops += 1
            if self._loop_service_fn is not None:
                self._loop_service_fn()
            return
        (kf_id,) = struct.unpack("<i", msg)
        # Detection only reads the map (BoW registration changes only the
        # loop closer's own database): run it on a snapshot outside the
        # structural lock, so keyframe insertion and mapping never wait on
        # the detector's host reads. Only an accepted closure takes the
        # lock, for the correction (DetectLoop vs CorrectLoop's map-update
        # mutex, src/LoopClosing.cc:113,462).
        snapshot, _ = self.box.read()
        apply_fn = self._loop_fn(snapshot, kf_id)
        if apply_fn is not None:
            self.box.mutate(apply_fn)
            self.n_loops += 1
        if self._loop_service_fn is not None:
            self._loop_service_fn()
        self.n_loop_rounds += 1

    # -- shutdown (System::Shutdown barrier, src/System.cc:570-596) ----------
    def shutdown(self, drain: bool = True):
        """Stop both workers, after their queues drain unless drain=False;
        raises a worker's exception."""
        if not drain:
            self.map_q.clear()
            if self.loop_q is not None:
                self.loop_q.clear()
        self.map_q.close()
        try:
            self._map_worker.join()
        finally:
            self._queued.clear()
            if self.loop_q is not None:
                self.loop_q.close()
                self._loop_worker.join()

    def raise_worker_errors(self):
        for w in (self._map_worker, self._loop_worker):
            if w is not None and w.exception is not None:
                raise w.exception
