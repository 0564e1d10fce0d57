"""`BENCHMARK.json` and the files it names.

Every piece of a cell is found by name: the configuration in
`configs/<config>.json`, the traffic mix in `traffic/<traffic>.json`, the
limits of the correctness check in `limits/<cell>.json`, each metric's
reader in `metrics/<metric>.py` (a function `read(run)` that returns the
number, or None where the run holds nothing to read), each camera path other
than the renderer's own orbit and dolly in `paths/<kind>.py` (a function
`poses(frames, **params)` that returns the true Tcw, (n, 4, 4)), and each
compared number that `check.py` does not compute in `checks/<name>.py` (a
function `number(ctx)` that returns it; see `check.judge`). A path file
imports numpy only, a check file nothing of the program. The sensor is one
of the table in `sensors.py`. A new cell, metric, camera path or compared
number is a new file and a new entry; no file that is there changes.
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
        return load(self.here, "metrics", metric, "read")

    def check(self, name: str):
        """The `number(ctx)` function of `checks/<name>.py`."""
        return load(self.here, "checks", name, "number")


def load(here: Path, kind: str, name: str, function: str):
    """The function `function` of the file `<here>/<kind>/<name>.py`; a
    ValueError naming the file where there is none."""
    path = Path(here) / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"nothing named {name!r}: there is no {Path(here).name}/{kind}/{name}.py")
    spec = importlib.util.spec_from_file_location(f"slam_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, function, None)):
        raise ValueError(f"{path} has no function {function}()")
    return getattr(mod, function)
