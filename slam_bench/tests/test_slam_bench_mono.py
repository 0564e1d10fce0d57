"""A monocular cell run through the harness on the CPU, as a later change
would add one: its configuration, traffic, limits, camera path and compared
number as new files of a copy of the harness. Nothing of it is a cell of
BENCHMARK.json."""

import json
import math
import time

import torch

from slam_bench import run
from slam_bench_copy import add_cell, add_samples, copy_harness
from test_slam_bench_check import SMALL

SEED = 2**31 + 13
# The sample path swings the camera 1 m to each side of (0, 0, 0.5) once
# every 96 frames, facing the boxes and the far wall: the port's two-view
# initializer finds its pair within the first 6-10 frames at this size.
SWEEP = {"kind": "sweep", "center": [0.0, 0.0, 0.5], "amplitude_m": 1.0, "period": 96}


def test_a_monocular_cell_runs_and_is_checked(tmp_path):
    here = copy_harness(tmp_path)
    add_samples(here)
    cfg = json.loads((here / "configs" / "tum_rgbd.json").read_text())
    cfg.update(name="tum_mono", sensor="monocular")
    cfg["slam"].update(SMALL["tum_rgbd"], bf=0.0)  # a monocular camera has no baseline
    traffic = json.loads((here / "traffic" / "orbit_explore.json").read_text())
    traffic.update(name="sweep", sensor="monocular", path=SWEEP, frames=[0, 96], room_planes=16)
    limits = json.loads((here / "limits" / "tum_rgbd.orbit_explore.json").read_text())
    limits.update(ate_m=0.05, first_pose_frame=24)
    man = add_cell(tmp_path, here, "tum_mono.sweep", cfg, traffic, limits)
    torch.set_num_threads(4)
    res = run.run_cell(man, "tum_mono.sweep", SEED, 30.0, traced=False, device="cpu", t_start=time.perf_counter())
    checked = {name: c["value"] for name, c in res["checked"].items()}
    assert checked["unanswered"] == 0
    assert checked["orb_keypoints_differ"] == 0 and checked["orb_bits_differ"] == 0
    assert checked["first_pose_frame"] <= 24
    assert math.isfinite(checked["ate_m"]) and math.isfinite(checked["map_point_m"])
    assert res["attempted"] > 0
