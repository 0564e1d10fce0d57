"""A copy of the harness in a test's directory, and a cell added to it as a
later change adds one: new files and new entries in BENCHMARK.json."""

import json
import shutil
from pathlib import Path

from slam_bench.manifest import HERE, ROOT, Manifest

SAMPLES = Path(__file__).resolve().parent / "samples"


def copy_harness(root: Path) -> Path:
    """`root/slam_bench` and `root/BENCHMARK.json`, copied; returns the former."""
    shutil.copytree(HERE, root / "slam_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root / "slam_bench"


def add_samples(here: Path):
    """The sample camera path and compared number (`samples/`) as new files
    of the copy's `paths/` and `checks/`."""
    for kind in ("paths", "checks"):
        (here / kind).mkdir(exist_ok=True)
        for f in (SAMPLES / kind).glob("*.py"):
            shutil.copy(f, here / kind / f.name)


def add_cell(root: Path, here: Path, cell: str, config: dict, traffic: dict, limits: dict) -> Manifest:
    """A cell whose configuration, traffic and limits are new files and
    whose entries are new in BENCHMARK.json."""
    (here / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    (here / "traffic" / f"{traffic['name']}.json").write_text(json.dumps(traffic))
    (here / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": config["name"], "source": "x", "reduced": [],
                             "file": f"slam_bench/configs/{config['name']}.json", "why": "x"})
    bench["workloads"].append({"name": cell, "config": config["name"], "traffic": traffic["name"], "chips": 1,
                               "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Manifest(root=root, here=here)
