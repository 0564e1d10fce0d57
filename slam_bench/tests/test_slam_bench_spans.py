"""The readers of the program's spans and wait counters on made-up runs:
nothing from a run that lacks the name (a program without the span), an
empty list or a ring that lost records (None); the median or the mean
otherwise."""

from collections import deque
from time import perf_counter_ns
from types import SimpleNamespace

import numpy as np
import pytest

from slam_bench import window
from slam_bench.manifest import Manifest

MEDIANS = {"frame_build_ms_p50": "frame_build", "tracking_ms_p50": "tracking", "map_queue_ms_p50": "map_queue",
           "local_ba_ms_p50": "local_ba"}
MEANS = {"tracker_read_wait_ms_per_frame": "track_read_wait", "tracker_map_wait_ms_per_frame": "track_map_wait"}
READERS = {**MEDIANS, **MEANS}


@pytest.fixture(scope="module")
def man():
    return Manifest()


@pytest.mark.parametrize("metric", sorted(READERS))
def test_nothing_to_read_gives_none(man, metric):
    read = man.reader(metric)
    # A program without the span (the parent commit): the key is missing.
    assert read(SimpleNamespace(stage_ms={"map": [1.0], "loop": [2.0], "track": [3.0]})) is None
    assert read(SimpleNamespace(stage_ms={READERS[metric]: []})) is None
    assert read(SimpleNamespace(stage_ms={READERS[metric]: None})) is None


@pytest.mark.parametrize("metric", sorted(MEDIANS))
def test_medians(man, metric):
    samples = [9.0, 1.0, 4.0, 100.0]
    run = SimpleNamespace(stage_ms={MEDIANS[metric]: samples})
    assert man.reader(metric)(run) == pytest.approx(6.5)
    assert man.reader(metric)(run) == pytest.approx(float(np.percentile(samples, 50)))


@pytest.mark.parametrize("metric", sorted(MEANS))
def test_means(man, metric):
    run = SimpleNamespace(stage_ms={MEANS[metric]: [0.0, 0.0, 3.0, 9.0]})
    assert man.reader(metric)(run) == pytest.approx(3.0)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_read_through_the_window_cut(man, metric):
    """The samples come through `window.Stages`: gathered from the span
    ring, cut at the window's start, and a ring that lost records between
    two gathers reads nothing."""
    name = READERS[metric]
    ring = deque(maxlen=4)

    def span(ms):
        t = perf_counter_ns()
        ring.append((name, "tracker", 0, None, t, t, ms))

    slam = SimpleNamespace(_metrics={name: deque(maxlen=1)}, _rec=SimpleNamespace(ring=ring))
    span(50.0)
    stages = window.Stages(slam)
    span(2.0)
    span(4.0)
    stages.gather()
    assert man.reader(metric)(SimpleNamespace(stage_ms=stages.samples())) == pytest.approx(3.0)
    for _ in range(5):  # the ring wraps past the last gather's newest record
        span(6.0)
    stages.gather()
    assert man.reader(metric)(SimpleNamespace(stage_ms=stages.samples())) is None


def test_entries(man):
    by_name = {m["name"]: m for m in man.data["per_layer"]}
    for metric in READERS:
        m = by_name[metric]
        assert m["source"] == ("program_counter" if metric in MEANS else "program_span")
        assert m["unit"] == ("ms/frame" if metric in MEANS else "ms")
    for metric in ("map_queue_ms_p50", "local_ba_ms_p50"):
        assert by_name[metric]["workloads"] == ["tum_rgbd.orbit_explore"]
    cells = [w["name"] for w in man.data["workloads"]]
    for cell in cells:
        assert set(READERS) <= {m["name"] for m in man.metrics(cell, traced=True)}
