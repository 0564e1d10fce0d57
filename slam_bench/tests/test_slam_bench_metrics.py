"""The metric arithmetic on made-up samples."""

from types import SimpleNamespace

import numpy as np
import pytest

from slam_bench import peaks, trace
from slam_bench.manifest import Manifest


@pytest.fixture(scope="module")
def read():
    man = Manifest()
    return lambda name, run: man.reader(name)(run)


def test_rate_and_percentiles_over_all_frames(read):
    lat = [0.1] * 80 + [0.5] * 15 + [2.0] * 5  # seconds
    run = SimpleNamespace(latencies_s=lat, seconds=20.0)
    assert read("frames_per_s", run) == pytest.approx(5.0)
    assert read("frame_p50_ms", run) == pytest.approx(float(np.percentile(lat, 50)) * 1e3)
    assert read("frame_p50_ms", run) == pytest.approx(100.0)
    empty = SimpleNamespace(latencies_s=[], seconds=20.0)
    assert read("frames_per_s", empty) is None and read("frame_p50_ms", empty) is None


def test_counters_and_stage_samples(read):
    run = SimpleNamespace(attempted=10, counters_start={"reads": {"tracker": 5, "mapping": 3}},
                          counters_end={"reads": {"tracker": 225, "mapping": 40}},
                          stage_ms={"map": [300.0, 100.0, 200.0], "loop": []})
    assert read("tracker_reads_per_frame", run) == pytest.approx(22.0)
    assert read("map_round_ms_p50", run) == pytest.approx(200.0)
    assert read("loop_round_ms_p50", run) is None


def test_stage_samples_are_cut_at_the_window_start(read):
    """Samples come from the span ring (`window.Stages`): those that ended
    before the window are left out, those gathered before the ring wraps are
    kept however many a name's deque would hold, and a ring that lost
    records between two gathers reads nothing."""
    from collections import deque
    from time import perf_counter_ns

    from slam_bench import window

    ring = deque(maxlen=6)

    def span(name, ms):
        t = perf_counter_ns()
        ring.append((name, "mapping", 0, None, t, t, ms))

    slam = SimpleNamespace(_metrics={"map": deque(maxlen=2), "loop": deque(maxlen=2), "track": deque(maxlen=2)},
                           _rec=SimpleNamespace(ring=ring))
    span("map", 900.0)  # set-up left two map rounds
    span("map", 800.0)
    stages = window.Stages(slam)
    span("map", 300.0)
    span("map", 100.0)
    span("loop", 5.0)
    stages.gather()
    stage = stages.samples()
    assert stage["map"] == [300.0, 100.0] and stage["loop"] == [5.0] and stage["track"] == []
    run = SimpleNamespace(stage_ms=stage)
    assert read("map_round_ms_p50", run) == pytest.approx(200.0)
    for ms in (50.0, 60.0, 70.0, 80.0):  # the ring wraps, more rounds than the map deque holds
        span("map", ms)
    stages.gather()
    assert stages.samples()["map"] == [300.0, 100.0, 50.0, 60.0, 70.0, 80.0]
    for _ in range(7):  # more than the ring holds before the next gather
        span("track", 1.0)
    stages.gather()
    assert read("map_round_ms_p50", SimpleNamespace(stage_ms=stages.samples())) is None


def test_idle_share_is_one_minus_the_interval_union():
    ns = 1_000_000  # 1 ms
    events = [("k1", 0, 10 * ns), ("k2", 5 * ns, 20 * ns), ("Memcpy HtoD", 30 * ns, 40 * ns),
              ("k3", 90 * ns, 120 * ns)]  # k3 runs past the stretch's end
    s = trace.reduce(events, 0, 100 * ns, [("track", 0, 60 * ns), ("reset", 60 * ns, 100 * ns)])
    assert s["busy_s"] == pytest.approx(0.040)
    assert s["window_s"] == pytest.approx(0.100)
    assert s["kernels"] == 3
    assert s["idle_gaps"][0] == ["reset, then k3", pytest.approx(0.050)]
    assert [g[1] for g in s["idle_gaps"]] == pytest.approx([0.050, 0.010])
    run = SimpleNamespace(trace=s, trace_frames=6)
    man = Manifest()
    assert man.reader("device_idle_share")(run) == pytest.approx(60.0)
    assert man.reader("kernels_per_frame")(run) == pytest.approx(0.5)
    assert man.reader("device_idle_share")(SimpleNamespace(trace=None)) is None


def test_fast_score_nms_roofline_bound():
    ops, n_bytes = peaks.fast_cells_work(480, 640, 8, 1.2)
    assert ops == 185 * 950_532  # the 8 levels of a 640x480 frame
    assert peaks.least_seconds(ops, n_bytes) == pytest.approx(ops / 33.5e12)
    assert peaks.least_seconds(ops, n_bytes) * 1e6 == pytest.approx(5.25, abs=0.01)
    name = "void (anonymous namespace)::fast_kernel<true>((anonymous namespace)::Pyramid, float*)"
    # Ten launches that took four times the bound each: 25%.
    s = {"by_name": {name: [10, 40 * ops / 33.5e12], "other": [5, 1.0]}}
    run = SimpleNamespace(trace=s, slam_cfg={"height": 480, "width": 640, "n_levels": 8, "scale_factor": 1.2})
    assert Manifest().reader("fast_score_nms_roofline")(run) == pytest.approx(25.0)
    assert Manifest().reader("fast_score_nms_roofline")(SimpleNamespace(trace={"by_name": {}})) is None


def test_short_kernel_names():
    assert trace.short_name("void at::native::k<4, F<float> >(int, F<float>)") == "at::native::k<4, F<float> >"
