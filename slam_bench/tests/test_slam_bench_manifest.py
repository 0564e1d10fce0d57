"""BENCHMARK.json against the benchmark's rules, and the harness finding
every piece of a cell by name, also one added as new files only."""

import hashlib
import json
import re
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from slam_bench.manifest import HERE, ROOT, Manifest
from slam_bench_copy import add_cell, add_samples, copy_harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["slam_bench"]
    assert 1 <= len(bench["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # A full check with 24 cells has to fit its time.
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("slam_bench/") and (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert w["config"] in names and len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_every_moves_is_reported_where_listed(bench):
    man = Manifest()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            assert m["moves"] in {x["name"] for x in man.metrics(cell, traced=False)}
    for w in bench["workloads"]:
        reported = {x["name"] for x in man.metrics(w["name"], traced=False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert man.metrics(w["name"], traced=True)


def test_every_piece_found_by_name(bench):
    from slam_bench import check, run

    man = Manifest()
    for w in bench["workloads"]:
        cfg, traffic, limits = man.config(w["config"]), man.traffic(w["traffic"]), man.limits(w["name"])
        assert cfg["name"] == w["config"] and traffic["name"] == w["traffic"]
        assert cfg["sensor"] == traffic["sensor"]
        assert {"unanswered", "map_point_m", "orb_keypoints_differ", "orb_bits_differ"} <= set(limits)
        parts = run.resolve(man, w["name"])
        assert set(limits) == {n for n in limits if n in check.NUMBERS} | set(parts.checks)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(man.reader(m["name"]))
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg["slam"]) and "assumed" in cfg


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_added_as_new_files(tmp_path, bench):
    shutil.copytree(HERE, tmp_path / "slam_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    here = tmp_path / "slam_bench"
    before = _digest(here)
    # New files only.
    cfg = json.loads((here / "configs" / "tum_rgbd.json").read_text())
    cfg["name"] = "tum_rgbd_small_map"
    cfg["slam"]["max_keyframes"] = 64
    (here / "configs" / "tum_rgbd_small_map.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "orbit_explore.json").read_text())
    traffic.update(name="orbit_half", frames=[0, 160])
    (here / "traffic" / "orbit_half.json").write_text(json.dumps(traffic))
    (here / "limits" / "tum_rgbd_small_map.orbit_half.json").write_text(
        (here / "limits" / "tum_rgbd.orbit_explore.json").read_text())
    (here / "metrics" / "frames_submitted.py").write_text("def read(run):\n    return run.attempted\n")
    # One entry each in BENCHMARK.json.
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tum_rgbd_small_map", "source": "x", "reduced": ["max_keyframes"],
                             "file": "slam_bench/configs/tum_rgbd_small_map.json", "why": "x"})
    bench["workloads"].append({"name": "tum_rgbd_small_map.orbit_half", "config": "tum_rgbd_small_map",
                               "traffic": "orbit_half", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_submitted", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "entry point and pipelined tracking",
                               "moves": "frames_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digest(here)
    assert all(after[f] == h for f, h in before.items()), "an existing file of the harness changed"
    man = Manifest(root=tmp_path, here=here)
    cell = man.cell("tum_rgbd_small_map.orbit_half")
    assert man.config(cell["config"])["slam"]["max_keyframes"] == 64
    assert man.traffic(cell["traffic"])["frames"] == [0, 160]
    assert man.limits(cell["name"])["unanswered"] == 0
    names = [m["name"] for m in man.metrics(cell["name"], traced=True)]
    assert "frames_submitted" in names
    assert man.reader("frames_submitted")(SimpleNamespace(attempted=7)) == 7


def test_every_traffic_feeds_what_the_window_runs():
    from slam_bench import stream

    for path in sorted((HERE / "traffic").glob("*.json")):
        traffic = json.loads(path.read_text())
        assert traffic["name"] == path.stem and traffic["feed"] in stream.FEEDS
    traffic = Manifest().traffic("orbit_explore")
    slam_cfg = Manifest().config("tum_rgbd")["slam"]
    with pytest.raises(ValueError, match="feed"):
        stream.render_session(slam_cfg, "rgbd", dict(traffic, feed="open_loop"), 1, "cpu")


def test_a_sensor_a_path_and_a_check_added_as_new_files(tmp_path):
    """A monocular configuration, a camera path and a compared number come
    as new files and entries: found by name, used by `render_session` and
    `judge`, and no file that was there changes."""
    from slam_bench import check, run, stream

    import slam_bench_synthetic as syn

    here = copy_harness(tmp_path)
    before = _digest(here)
    add_samples(here)
    cfg = json.loads((here / "configs" / "tum_rgbd.json").read_text())
    cfg.update(name="tum_mono", sensor="monocular")
    cfg["slam"].update(width=80, height=60, fx=68.75, fy=68.75, cx=40.0, cy=30.0, bf=0.0)
    traffic = json.loads((here / "traffic" / "orbit_explore.json").read_text())
    traffic.update(name="sweep", sensor="monocular", frames=[0, 4], room_planes=16,
                   path={"kind": "sweep", "center": [0.0, 0.0, 0.5], "amplitude_m": 1.0, "period": 96})
    limits = {"unanswered": 0, "ate_m": 0.05, "first_pose_frame": 10}
    man = add_cell(tmp_path, here, "tum_mono.sweep", cfg, traffic, limits)
    after = _digest(here)
    assert all(after[f] == h for f, h in before.items()), "an existing file of the harness changed"

    parts = run.resolve(man, "tum_mono.sweep")
    assert set(parts.checks) == {"first_pose_frame"} and parts.limits == limits
    sess = stream.render_session(cfg["slam"], "monocular", traffic, 7, "cpu", parts.poses)
    x = np.sin(2 * np.pi * np.arange(4) / 96)
    np.testing.assert_allclose(sess.gt[:, 0, 3], -x, atol=1e-7)
    assert sess.second is None and sess.first.shape == (4, 60, 80)
    win, maps = syn.run(syn.session(), sessions=(
        {"frames": 10, "keyframes": (6,), "unpublished": (0, 1, 2, 3, 4), "lost": ()},))
    ok, rows, numbers = check.judge(win, maps, syn.session(), dict(cfg, slam=syn.CFG), limits, 1, parts.checks)
    assert [r[0] for r in rows] == list(limits) and numbers["first_pose_frame"] == 5.0
    assert ok


@pytest.mark.parametrize("what", ["sensor", "path", "limit"])
def test_a_name_that_resolves_to_nothing_fails_before_set_up(tmp_path, monkeypatch, what):
    """A misnamed sensor, camera path or limit fails before the card is
    touched, naming the file looked for."""
    import torch

    from slam_bench import run, stream

    def touched(*a, **k):
        raise AssertionError("set-up began")

    monkeypatch.setattr(torch.cuda, "init", touched)
    monkeypatch.setattr(stream, "render_session", touched)
    here = copy_harness(tmp_path)
    cfg = json.loads((here / "configs" / "tum_rgbd.json").read_text())
    traffic = json.loads((here / "traffic" / "orbit_explore.json").read_text())
    limits = json.loads((here / "limits" / "tum_rgbd.orbit_explore.json").read_text())
    cfg, traffic, looked_for = dict(cfg, name="c"), dict(traffic, name="t"), {
        "sensor": "slam_bench/sensors.py", "path": "slam_bench/paths/spiral.py",
        "limit": "slam_bench/checks/gap_m.py"}[what]
    if what == "sensor":
        cfg["sensor"] = traffic["sensor"] = "sonar"
    elif what == "path":
        traffic["path"] = {"kind": "spiral", "turns": 2}
    else:
        limits["gap_m"] = 0.1
    man = add_cell(tmp_path, here, "c.t", cfg, traffic, limits)
    with pytest.raises(ValueError, match=re.escape(looked_for)):
        run.run_cell(man, "c.t", 1, 1.0, traced=False, device="cuda")
