"""The correctness check comes out false when the timed path is broken
underneath: the harness's run of each cell, without its look for a card,
on the CPU at half the widths and heights, with one fault planted in the
program at a time and the cell's own limits."""

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from slam_bench import run
from slam_bench.manifest import HERE, ROOT, Manifest
from slam_bench_faults import FAULTS

SEED = 2**31 + 11
# The cells of BENCHMARK.json, and the candidate cells whose configuration
# and traffic files are kept for a later benchmark (PERF.md, Open
# questions): registered in the copy only. The loop cell has no limits of
# its own yet; its sound run here asserts nothing that needs one.
CANDIDATES = {"tum_rgbd.orbit_loop": "tum_rgbd.orbit_explore", "kitti_stereo.dolly": "kitti_stereo.dolly"}
CELLS = ["tum_rgbd.orbit_loop", "kitti_stereo.dolly", "tum_rgbd.orbit_explore"]
# At this size the loop cell's preroll shrinks from 161 frames to 10, and a
# frozen tracker relocalizes back onto the truth, so its faults are not
# held here.
FAULT_CELLS = ["kitti_stereo.dolly", "tum_rgbd.orbit_explore"]
# Half the published widths and heights, so that the CPU runs some tens of
# frames in the window: enough rotation (orbit) and travel (dolly) for a
# frozen pose to show against the cells' own limits. The stereo rig keeps
# its bf (a baseline twice as wide), so that its depths are as precise in
# pixels of disparity as at the published size.
SMALL = {
    "tum_rgbd": dict(width=320, height=240, fx=275.0, fy=275.0, cx=160.0, cy=120.0, max_keyframes=32,
                     max_map_points=4096),
    "kitti_stereo": dict(width=620, height=188, fx=359.428, fy=359.428, cx=303.6, cy=92.6,
                         n_features=1000, max_keyframes=32, max_map_points=4096),
}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A copy of the benchmark whose cells run at a size the CPU holds."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(HERE, root / "slam_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = root / "slam_bench"
    named = {w["name"] for w in bench["workloads"]}
    for cell, limits_of in CANDIDATES.items():
        if cell in named:
            continue
        config, traffic = cell.split(".")
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": "x"})
        if limits_of != cell:
            shutil.copy(here / "limits" / f"{limits_of}.json", here / "limits" / f"{cell}.json")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for name, sizes in SMALL.items():
        path = here / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["slam"].update(sizes)
        path.write_text(json.dumps(cfg))
    for path in (here / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic["warmup"] = {"gba_buckets": [], "fuse_buckets": []}
        traffic["preroll"] = min(traffic.get("preroll", 0), 10)
        path.write_text(json.dumps(traffic))
    return Manifest(root=Path(root), here=here)


def _run(man, cell):
    torch.set_num_threads(4)
    return run.run_cell(man, cell, SEED, 30.0, traced=False, device="cpu", t_start=time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_answers_and_matches_the_plain_orb(small, cell):
    """A sound run at this size: every frame answered, the features equal to
    the plain ORB's, the result's shape. (Its pose and map numbers are not
    held to the limits, which are set at the cell's own size.)"""
    res = _run(small, cell)
    checked = res["checked"]
    assert checked["unanswered"]["value"] == 0
    assert checked["orb_keypoints_differ"]["value"] == 0 and checked["orb_bits_differ"]["value"] == 0
    assert res["attempted"] > 0 and list(checked)[0] == "unanswered"
    assert list(res)[-1] == "checked"


@pytest.mark.parametrize("cell", FAULT_CELLS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_path_is_not_correct(small, monkeypatch, cell, fault):
    target, name, wrap = FAULTS[fault]
    monkeypatch.setattr(target, name, wrap(getattr(target, name)))
    res = _run(small, cell)
    assert not res["correct"], res["checked"]
