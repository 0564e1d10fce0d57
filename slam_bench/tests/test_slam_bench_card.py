"""On the card: each cell runs for a few seconds and proves correct, and the
control (the program with TF32 on) does not, nor does the program with a fault
planted, at the cell's size and window (the readings are printed). Skipped without a
card:

    python3 -m pytest slam_bench/tests/test_slam_bench_card.py -q -s
"""

import json
import time

import pytest

from slam_bench import run
from slam_bench.manifest import ROOT, Manifest
from slam_bench_faults import FAULTS

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return Manifest()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(card, cell):
    res = run.run_cell(card, cell, 2**31 + 101, 8.0, traced=False, t_start=time.perf_counter())
    assert res["correct"], res["checked"]
    assert res["attempted"] > 0 and res["metrics"]["frames_per_s"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    res = run.run_cell(card, cell, 2**31 + 103, 8.0, traced=False, t_start=time.perf_counter(), tf32=True)
    print(json.dumps({"cell": cell, "control": "tf32", "checked": {k: v["value"] for k, v in res["checked"].items()}}))
    assert not res["correct"], res["checked"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "map_points_altered"])
def test_fault_at_the_cell_size_is_not_correct(card, monkeypatch, cell, fault):
    target, name, wrap = FAULTS[fault]
    monkeypatch.setattr(target, name, wrap(getattr(target, name)))
    res = run.run_cell(card, cell, 2**31 + 107, BENCH["run_seconds"], traced=False, t_start=time.perf_counter())
    print(json.dumps({"cell": cell, "fault": fault, "checked": {k: v["value"] for k, v in res["checked"].items()}}))
    assert not res["correct"], res["checked"]
