"""`BENCHMARK.json` and the files it names.

Every piece of a cell is found by name: the configuration in
`configs/<config>.json`, the traffic mix in `traffic/<traffic>.json`, the
limits of the correctness check in `limits/<cell>.json`, and each metric's
reader in `metrics/<metric>.py` (a function `read(run)` that returns the
number, or None where the run holds nothing to read). A new cell or metric
is a new file and a new entry; no file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.root, self.here = Path(root), Path(here)
        self.data = _json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _json(self.here / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return _json(self.here / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return _json(self.here / "limits" / f"{cell}.json")

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics (untraced) or per-layer metrics
        (traced): those that list the cell, or list no cells."""
        group = self.data["per_layer" if traced else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The `read(run)` function of `metrics/<metric>.py`."""
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
