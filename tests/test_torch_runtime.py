"""The port's native runtime (`runtime/native.py`), its async pipeline
(`runtime/pipeline.py`) and the counters that several threads now share.

Mirrors `tests/test_runtime.py:25-90,115-170` without the TCP transport:
queue FIFO and close, a bounded push blocking until a pop, the flag, worker
drain and join, a worker's exception raised on join, `now_ns`, the
`MapBox` versioned publish, and the `AsyncMapper` skipping BA under pressure
and publishing a closure. The scripted `AsyncMapper` runs go through both
packages' classes, which must end in the same state. Every wait is bounded.
"""

import struct
import sys
import threading
import time

import pytest
import torch

from orb_slam2v2_1_tpu.runtime import pipeline as jpipeline

from orb_slam2v2_1_tpu_torch import kernels, sync
from orb_slam2v2_1_tpu_torch.runtime import native, pipeline
from orb_slam2v2_1_tpu_torch.runtime.native import NativeFlag, NativeQueue, NativeWorker, now_ns

PIPELINES = pytest.mark.parametrize("pkg", [pipeline, jpipeline], ids=["port", "reference"])


def test_library_built_beside_the_build_tree():
    """Built from native/runtime.cc into build/torch_runtime/ under a name
    keyed on the source, never as native/liborbslam_rt.so."""
    path = native.build()
    assert path.parent == native.ROOT / "build" / "torch_runtime" and path.exists()
    assert path.name.startswith("liborbslam_rt_") and path.name != "liborbslam_rt.so"
    assert native.SOURCE == native.ROOT / "native" / "runtime.cc"
    assert native.build() == path  # content-keyed: found, not rebuilt


def test_queue_fifo_and_close():
    q = NativeQueue(8)
    for i in range(5):
        assert q.push(struct.pack("<i", i))
    assert len(q) == 5
    for i in range(5):
        assert q.pop(timeout_ms=100) == struct.pack("<i", i)
    assert q.pop(timeout_ms=10) is None  # timeout, empty
    q.close()
    assert not q.push(b"x", timeout_ms=10)  # closed: refused
    with pytest.raises(EOFError):
        q.pop(timeout_ms=100)
    q.free()


def test_queue_bounded_blocks_until_pop():
    q = NativeQueue(1)
    assert q.push(b"a")
    assert not q.push(b"b", timeout_ms=30)  # full -> timeout
    popped = []
    t = threading.Thread(target=lambda: popped.append(q.pop(timeout_ms=1000)))
    t.start()
    assert q.push(b"b", timeout_ms=1000)  # unblocked by the pop
    t.join(timeout=5)
    assert not t.is_alive() and popped == [b"a"]
    q.close()
    q.free()


def test_flag_exchange():
    f = NativeFlag()
    assert not f
    f.set(2)
    assert f.get() == 2
    assert f.exchange(0) == 2
    assert f.get() == 0 and not f
    f.set()
    assert f
    f.clear()
    assert not f
    f.free()


def test_worker_drains_then_joins():
    q = NativeQueue(64)
    got = []
    w = NativeWorker(q, lambda m: got.append(m))
    for i in range(20):
        q.push(struct.pack("<i", i))
    q.close()  # close-with-drain: the worker processes all 20 first
    w.join()
    assert got == [struct.pack("<i", i) for i in range(20)]
    assert w.done()
    w.free()
    q.free()


def test_worker_exception_propagates_on_join():
    q = NativeQueue(4)

    def boom(msg):
        raise ValueError("bad message")

    w = NativeWorker(q, boom)
    q.push(b"x")
    with pytest.raises(ValueError, match="bad message"):
        w.join()
    assert w.done() and isinstance(w.exception, ValueError)
    q.close()
    w.free()
    q.free()


def test_now_ns_monotone():
    a = now_ns()
    b = now_ns()
    assert b >= a > 0


@PIPELINES
def test_mapbox_versioned_publish(pkg):
    box = pkg.MapBox("v0")
    assert box.read() == ("v0", 0)
    assert box.publish("v1")
    assert not box.publish("stale", expected_version=0)  # lost the race
    assert box.publish("v2", expected_version=1)
    assert box.read() == ("v2", 2) and box.version == 2
    assert box.mutate(lambda s: s + "+") == "v2+" and box.read() == ("v2+", 3)


@PIPELINES
def test_async_mapper_skips_ba_under_pressure(pkg):
    box = pkg.MapBox({"kfs": []})
    slow = threading.Event()

    def mapping_fn(state, kf_id, allow_ba):
        if not slow.is_set():
            time.sleep(0.05)  # a backlog, so that later BA stages are skipped
        return {"kfs": state["kfs"] + [(kf_id, allow_ba)]}

    m = pkg.AsyncMapper(box, mapping_fn)
    try:
        for i in range(8):
            m.submit_keyframe(i)
        slow.set()
    finally:
        m.shutdown(drain=True)
    state, _ = box.read()
    assert [k for k, _ in state["kfs"]] == list(range(8))
    assert m.n_processed == 8
    # With a backlog, at least one BA round was skipped (mbAbortBA analog).
    assert m.n_ba_skipped >= 1 and m.n_ba_skipped == sum(not ba for _, ba in state["kfs"])
    m.raise_worker_errors()


@PIPELINES
def test_async_mapper_loop_worker_publishes_on_closure(pkg):
    box = pkg.MapBox(0)
    seen = []

    def mapping_fn(state, kf_id, allow_ba):
        return state + 1

    def loop_fn(snapshot, kf_id):
        # Detection: read-only on the snapshot; a closure on keyframe 3 is
        # returned as the change to apply under the structural lock.
        seen.append((kf_id, snapshot))
        return (lambda state: state + 100) if kf_id == 3 else None

    m = pkg.AsyncMapper(box, mapping_fn, loop_fn=loop_fn)
    try:
        for i in range(5):
            m.submit_keyframe(i)
    finally:
        m.shutdown(drain=True)
    assert m.n_processed == 5 and m.n_loops == 1
    assert box.read()[0] == 105
    assert [k for k, _ in seen] == list(range(5))
    assert all(snap >= k + 1 for k, snap in seen)  # each round sees its own mapping round


def test_async_mapper_counts_rounds_and_stops_without_draining():
    box = pipeline.MapBox(0)
    gate = threading.Event()

    def mapping_fn(state, kf_id, allow_ba):
        gate.wait(5)
        return state + 1

    m = pipeline.AsyncMapper(box, mapping_fn, loop_fn=lambda snap, k: None, loop_service_fn=lambda: None)
    for i in range(6):
        m.submit_keyframe(i)
    assert m.n_submitted == 6
    m.map_q.clear()  # what shutdown(drain=False) does first, before the gate opens
    gate.set()
    m.shutdown(drain=False)
    assert m.n_processed == m.n_loop_rounds < 6
    assert m._map_worker.done() and m._loop_worker.done()


def test_wait_rounds_waits_for_rounds_tagged_up_to_the_frame():
    """The tracker's lag bound: `wait_rounds(f)` returns once every round
    submitted at a frame <= f has ended, waits for none submitted later, and
    counts its wait on the map wait clock."""
    from orb_slam2v2_1_tpu_torch import spans

    box = pipeline.MapBox(0)
    gates = [threading.Event() for _ in range(2)]

    def mapping_fn(state, kf_id, allow_ba):
        gates[kf_id].wait(5)
        return state + 1

    m = pipeline.AsyncMapper(box, mapping_fn)
    try:
        m.submit_keyframe(0, 10)
        m.submit_keyframe(1, 12)
        m.wait_rounds(9)  # nothing tagged at or before frame 9: no wait
        assert m.n_processed == 0
        threading.Timer(0.2, gates[0].set).start()
        w0 = spans._T.waited[spans.MAP]
        t0 = time.monotonic()
        m.wait_rounds(11)  # round 0 only
        assert m.n_processed == 1 and time.monotonic() - t0 >= 0.15
        assert spans._T.waited[spans.MAP] - w0 >= 0.15e9
        m.wait_rounds(11)  # already waited for: returns at once
        gates[1].set()
        m.wait_rounds(12)
        assert m.n_processed == 2 and box.read()[0] == 2
    finally:
        for g in gates:
            g.set()
        m.shutdown(drain=True)


def test_wait_rounds_raises_a_failed_worker_error():
    box = pipeline.MapBox(0)

    def mapping_fn(state, kf_id, allow_ba):
        raise RuntimeError("mapping failed")

    m = pipeline.AsyncMapper(box, mapping_fn)
    m.submit_keyframe(0, 3)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="mapping failed"):
        m.wait_rounds(3)
    assert time.monotonic() - t0 < 30
    with pytest.raises(RuntimeError, match="mapping failed"):
        m.shutdown()


def test_failed_worker_surfaces_on_submit():
    """A mapping worker that raised stops taking keyframes; the tracker sees
    its error on the next submit instead of blocking on the full queue."""
    box = pipeline.MapBox(0)

    def mapping_fn(state, kf_id, allow_ba):
        raise RuntimeError("mapping failed")

    m = pipeline.AsyncMapper(box, mapping_fn, queue_cap=4)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="mapping failed"):
        for i in range(40):
            m.submit_keyframe(i)
    assert time.monotonic() - t0 < 30
    with pytest.raises(RuntimeError, match="mapping failed"):
        m.shutdown()


def test_failed_loop_worker_does_not_block_mapping():
    box = pipeline.MapBox(0)

    def loop_fn(snapshot, kf_id):
        raise ValueError("loop failed")

    m = pipeline.AsyncMapper(box, lambda s, k, ba: s + 1, loop_fn=loop_fn, queue_cap=2)
    with pytest.raises(ValueError, match="loop failed"):
        for i in range(40):
            m.submit_keyframe(i)
    with pytest.raises(ValueError, match="loop failed"):
        m.shutdown()
    assert m._map_worker.done() and m._loop_worker.done()


def test_counters_under_contention():
    """Kernel launch counts and host reads from more threads than cores,
    with a short switch interval: no increment lost, the split by thread
    role sums to the total."""
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    kernels.reset_launch_counts()
    sync.reset()

    def work(i):
        sync.set_role(f"w{i % 4}")
        for _ in range(n_each):
            kernels._launched("masked_best_two")
            sync.host(torch.zeros(()))

    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * n_each
    assert kernels.LAUNCHES["masked_best_two"] == total and kernels.LAUNCHES["fast_score_nms"] == 0
    assert kernels.LAUNCHES_BY_ROLE["masked_best_two"] == {f"w{j}": total // 4 for j in range(4)}
    assert sync.COUNT["syncs"] == total and sync.BY_ROLE == {f"w{j}": total // 4 for j in range(4)}
    assert sync.role() == "tracker"  # the caller's thread keeps its default
    kernels.reset_launch_counts()
    sync.reset()
    assert kernels.LAUNCHES_BY_ROLE["masked_best_two"] == {} and sync.BY_ROLE == {}


def test_async_read_on_the_cpu():
    """On the CPU the copy is made at once: ready, equal, independent of the
    tensor, and no read is counted."""
    sync.reset()
    t = torch.arange(9, dtype=torch.float32)
    r = sync.AsyncRead(t)
    t += 1
    assert r.is_ready()
    assert r.numpy().tolist() == list(range(9)) and sync.COUNT["syncs"] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_async_read_pinned_on_card(cuda_device):
    """On the card: a pinned host buffer and an event; once the stream has
    passed the copy, `is_ready` is true, the values are the tensor's and no
    read is counted."""
    t = torch.arange(9, dtype=torch.float32, device=cuda_device)
    r = sync.AsyncRead(t)
    assert r._host.is_pinned()
    torch.cuda.synchronize()
    sync.reset()
    assert r.is_ready()
    assert r.numpy().tolist() == list(range(9)) and sync.COUNT["syncs"] == 0
