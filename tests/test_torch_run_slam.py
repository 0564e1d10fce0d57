"""The command-line runner, `run_slam.py`, on both packages (CPU).

A TUM-layout directory is written from 14 frames of `evaluate.py`'s clean
desk sweep at 320x240 (`utils/datasets.write_tum_rgbd`: RGB and 16-bit depth
PNGs, depth stamped 4 ms after each image, the ground truth) with a settings
file in the reference's YAML style (fx=fy=275, 700 features: the depth
initializer wants 500 keypoints in one frame). Both CLIs run on it with
`--cpu --sync` (the reference reads the PNGs with PIL, so its half needs
PIL installed). Checks: the trajectory files hold the same frames within
2 mm / 0.05 deg, both print an ATE line, the port's saved map loads in the
reference's `load_map`, the two PLY exports agree within 1e-4 m, the frame
and map PNGs are written. Without `--cpu`, the port's CLI fails on a machine
without a card.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from orb_slam2v2_1_tpu import run_slam as jrun_slam
from orb_slam2v2_1_tpu.utils import serialization as jserialization

from orb_slam2v2_1_tpu_torch import run_slam
from orb_slam2v2_1_tpu_torch.ops import lie
from orb_slam2v2_1_tpu_torch.utils import config, datasets, synthetic

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 14
SETTINGS = """%YAML:1.0
# The desk sequence of evaluate.py at 320x240, no distortion.
Camera.fx: 275.0
Camera.fy: 275.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 10.0
Camera.bf: 44.0
ThDepth: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 700
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tum_desk")
    (root / "desk.yaml").write_text(SETTINGS)
    cfg = config.load_settings(root / "desk.yaml")
    imgs, deps, gt = synthetic.desk_frames(cfg, synthetic.desk_trajectory(150)[:N_FRAMES], device="cpu")
    datasets.write_tum_rgbd(root / "seq", imgs.numpy(), deps.numpy(), gt)
    return root


def _read_tum(path):
    rows = np.loadtxt(path, ndmin=2)
    return {round(r[0], 6): r[1:] for r in rows}


@pytest.fixture(scope="module")
def runs(tum_dir, tmp_path_factory):
    pytest.importorskip("PIL.Image")  # the reference's PNG reader
    outs = {}
    for name, main in (("ref", jrun_slam.main), ("port", run_slam.main)):
        out = tmp_path_factory.mktemp(name)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["--dataset", str(tum_dir / "seq"), "--settings", str(tum_dir / "desk.yaml"), "--cpu",
                         "--sync", "--out", str(out / "traj.txt"), "--save-map", str(out / "map.npz"), "--ply",
                         str(out / "map.ply"), "--viz-dir", str(out / "viz")]) == 0
        outs[name] = (out, buf.getvalue())
    return outs


def test_cli_trajectories_agree(runs):
    (ref_dir, ref_out), (got_dir, got_out) = runs["ref"], runs["port"]
    ref, got = _read_tum(ref_dir / "traj.txt"), _read_tum(got_dir / "traj.txt")
    assert sorted(got) == sorted(ref) and len(got) == N_FRAMES
    for t in ref:
        assert np.linalg.norm(got[t][:3] - ref[t][:3]) <= 2e-3, t
        Rg = lie.quat_to_rot(torch.tensor(got[t][3:], dtype=torch.float64)).numpy()
        Rr = lie.quat_to_rot(torch.tensor(ref[t][3:], dtype=torch.float64)).numpy()
        ang = np.degrees(np.arccos(np.clip((np.trace(Rg.T @ Rr) - 1) / 2, -1, 1)))
        assert ang <= 0.05, t
    for out in (ref_out, got_out):
        assert f"{N_FRAMES} frames in" in out and "ATE RMSE:" in out and "final stats:" in out
        assert "frame 0000/14" in out and "frame 0010/14" in out
    ate = [float(o.split("ATE RMSE:")[1].split()[0]) for o in (ref_out, got_out)]
    assert ate[1] <= 0.02 and abs(ate[1] - ate[0]) <= 2e-3


def test_cli_map_loads_in_reference_and_ply_agrees(runs):
    (ref_dir, _), (got_dir, _) = runs["ref"], runs["port"]
    jstate, meta = jserialization.load_map(got_dir / "map.npz")
    ref_state, _ = jserialization.load_map(ref_dir / "map.npz")
    assert int(jstate.n_kf) == int(ref_state.n_kf) >= 2 and int(meta["n_kf_host"]) >= 2
    assert int(np.asarray(jstate.mp_valid).sum()) == int(np.asarray(ref_state.mp_valid).sum())

    def ply(path):
        lines = path.read_text().splitlines()
        n = int(lines[2].split()[-1])
        return np.array([[float(v) for v in line.split()] for line in lines[lines.index("end_header") + 1:]]), n

    got, n_got = ply(got_dir / "map.ply")
    ref, n_ref = ply(ref_dir / "map.ply")
    assert n_got == n_ref == len(got) == int(np.asarray(jstate.mp_valid).sum())
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # The PLY holds the saved map's valid points.
    pos = np.asarray(jstate.mp_pos)[np.asarray(jstate.mp_valid)]
    np.testing.assert_allclose(got, pos, atol=1e-4)
    pngs = sorted(p.name for p in (got_dir / "viz").iterdir())
    assert "frame_00000.png" in pngs and "map_00000.png" in pngs


def test_port_cli_without_cpu_needs_a_card(tum_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would succeed")
    proc = subprocess.run(
        [sys.executable, "-m", "orb_slam2v2_1_tpu_torch.run_slam", "--dataset", str(tum_dir / "seq"), "--settings",
         str(tum_dir / "desk.yaml"), "--sync", "--out", str(tmp_path / "t.txt")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not (tmp_path / "t.txt").exists()
