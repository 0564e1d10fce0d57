"""The readers of the program's spans and wait counters on made-up runs:
nothing from a run that lacks the name (a program without the span), an
empty list or a full deque (None); the median or the mean otherwise."""

from collections import deque
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
    """The samples come through `window.stage_samples`: cut at the window's
    start, and a deque that filled in the window reads nothing."""
    name = READERS[metric]
    slam = SimpleNamespace(_metrics={name: deque([50.0], maxlen=4)})
    start = window.stage_lengths(slam)
    slam._metrics[name].extend([2.0, 4.0])
    got = man.reader(metric)(SimpleNamespace(stage_ms=window.stage_samples(slam, start)))
    assert got == pytest.approx(3.0)
    slam._metrics[name].append(6.0)  # full: its front is lost
    assert man.reader(metric)(SimpleNamespace(stage_ms=window.stage_samples(slam, start))) is None


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
