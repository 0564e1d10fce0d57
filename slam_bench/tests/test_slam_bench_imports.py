"""What the harness and the reference load, top-level names compared whole:
the JAX package's name is the port's without its suffix."""

import subprocess
import sys
import types
from pathlib import Path

from slam_bench import run
from slam_bench.manifest import HERE, ROOT
from slam_bench_copy import SAMPLES

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _loaded(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    import json

    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_program():
    names = _loaded("import slam_bench.reference.scene, slam_bench.reference.orb, "
                    "slam_bench.reference.trajectory, slam_bench.check, slam_bench.stream, slam_bench.peaks")
    assert not names & {"jax", "jaxlib", "flax", "orb_slam2v2_1_tpu", "orb_slam2v2_1_tpu_torch"}


def test_the_harness_and_the_port_load_no_jax():
    metrics = ", ".join(f"'{p.stem}'" for p in sorted((HERE / "metrics").glob("*.py")))
    names = _loaded(
        "import slam_bench.run, slam_bench.window, slam_bench.trace\n"
        "from slam_bench.manifest import Manifest\n"
        f"[Manifest().reader(m) for m in ({metrics},)]\n"
        "import orb_slam2v2_1_tpu_torch.models.system, orb_slam2v2_1_tpu_torch.kernels\n"
        "from orb_slam2v2_1_tpu_torch.runtime import native")
    assert "orb_slam2v2_1_tpu_torch" in names
    assert not names & set(run.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "orb_slam2v2_1_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "orb_slam2v2_1_tpu.ops", types.ModuleType("x"))
    assert run.forbidden_modules() == ["orb_slam2v2_1_tpu"]


def _files(kind: str) -> list[Path]:
    """The harness's files of `kind`, and the tests' samples of one."""
    return sorted((HERE / kind).glob("*.py")) + sorted((SAMPLES / kind).glob("*.py"))


def _load(path: Path, kind: str, function: str) -> str:
    here = str(path.parent.parent)
    return f"from slam_bench.manifest import load\nload({here!r}, {kind!r}, {path.stem!r}, {function!r})"


def test_camera_paths_load_numpy_only():
    files = _files("paths")
    assert files
    base = _loaded("import numpy\nimport slam_bench.manifest")
    for path in files:
        assert _loaded("import numpy\n" + _load(path, "paths", "poses")) == base, path


def test_checks_load_neither_jax_nor_the_program():
    files = _files("checks")
    assert files
    for path in files:
        names = _loaded(_load(path, "checks", "number"))
        assert not names & {*run.FORBIDDEN, "orb_slam2v2_1_tpu_torch"}, path
