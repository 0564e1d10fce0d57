"""The port's `bench` and `evaluate` entry points against the repository's
`bench.py` and `evaluate.py` (CPU).

- Leg definitions: `evaluate_synthetic(40, quick)` in both modules with the
  scene makers, the frame makers and `run_sequence` replaced by recorders
  that return fixed results: the same legs in the same order with the same
  configuration, sensor, frames, timestamps, ground truth (within 1e-5),
  `align_scale`, scene and degradation seeds, and exactly equal `checks`.
- `bench.main` in both with the frame maker and the three legs recorded: the
  same configurations (the benchmark's; fps=30 for the online leg) and the
  same JSON line, keys in order. `online_leg` and `kitti_leg` in both with
  a recording `SlamSystem`: the same configuration (KITTI's for the stereo
  leg), sensor, mode, `warmup` arguments, timestamps, dolly poses and
  output keys. `headline` in both on a recorded `track_sequence_rgbd`: 2
  warm-up and 3 timed runs, a fresh loop closer each, chunks of 32; both
  raise on a run that tracks under 90% or closes no loop.
- `evaluate --tum`: a TUM directory of 14 desk frames at 320x240 through
  both `main`s with `--cpu --tum --settings`: the same tracked count,
  keyframes and resets, ATE within 2 mm, the same `EVAL.json` keys and exit
  code (the reference reads the PNGs with PIL, so its half needs PIL).
- `run_sequence` of both on the first 16 frames of the clean desk at
  320x240 in sync mode: the same tracked count and keyframes, ATE within 2
  mm.
- Without `--cpu` and without a card both entry points exit non-zero with
  the device error.
- The port's `data/vocab.npz` equals the JAX package's array for array, and
  a `SlamSystem(device="cpu")` has a vocabulary and a loop closer.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2v2_1_tpu.models import offline as joffline
from orb_slam2v2_1_tpu.models import system as jsystem
from orb_slam2v2_1_tpu.ops import vocab as jvocab
from orb_slam2v2_1_tpu.utils import config as jconfig
from orb_slam2v2_1_tpu.utils import synthetic as jsyn

from orb_slam2v2_1_tpu_torch import bench, evaluate
from orb_slam2v2_1_tpu_torch.models import offline, system
from orb_slam2v2_1_tpu_torch.utils import config, datasets, synthetic

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
TUM_FRAMES, SEQ_FRAMES = 14, 16
BENCH_KW = dict(fx=550.0, fy=550.0, cx=320.0, cy=240.0, width=640, height=480, n_features=1000,
                max_keyframes=128, max_map_points=16384, fps=10.0, bf=44.0, th_depth=100.0)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"{name}_ref", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jevaluate():
    return _load("evaluate")


@pytest.fixture(scope="module")
def jbench():
    return _load("bench")


def _seed(rng):
    return int(rng.bit_generator.seed_seq.entropy)


def _norm(poses):
    return [np.asarray(p, np.float64) @ np.linalg.inv(poses[0]) for p in poses]


# ---------------------------------------------------------------------------
# (a) evaluate_synthetic: the legs
# ---------------------------------------------------------------------------
RESULT_ATE = [0.01, 0.05, 0.004, 0.02, 0.03, 0.2]
RESULT_POST = [1.0, 0.9, 1.0, 0.8, 1.0, 0.95]


class LegRecorder:
    """Scene makers, frame makers and `run_sequence` that record their
    calls. A frame maker returns tokens ("f", maker index, frame index)."""

    def __init__(self):
        self.makers, self.runs = [], []

    def scene(self, kind):
        def make(rng, *args, max_tilt_deg=None, **kw):
            return (kind, _seed(rng), max_tilt_deg)
        return make

    def frames(self, scene, poses, degrade, second=True):
        k = len(self.makers)
        self.makers.append({"scene": scene, "poses": [np.asarray(p, np.float64) for p in poses],
                            "degrade": degrade})
        return [("f", k, i) for i in range(len(poses))], ([("s", k, i) for i in range(len(poses))] if second else None)

    def run_sequence(self, cfg, sensor, frames, timestamps, gt, align_scale=False, async_mapping=False, **kw):
        i = len(self.runs)
        self.runs.append({"cfg": dataclasses.asdict(cfg), "sensor": sensor.name, "n": len(frames),
                          "maker": frames[0][0][1], "second": frames[0][1] is not None,
                          "ts": list(timestamps), "gt": gt, "align_scale": align_scale, "async": async_mapping})
        return {"ate_rmse_m": RESULT_ATE[i], "tracked": len(frames), "frames": len(frames), "tracked_frac": 1.0,
                "tracked_frac_post_init": RESULT_POST[i], "n_kf": 10 + i, "n_loops": 0, "n_resets": 0,
                "wall_s": 1.0}

    def legs(self, results):
        """Each leg by name: its run and its frame maker's record."""
        assert [r["tracked_frac_post_init"] for r in results.values()] == RESULT_POST[:len(results)]
        return {name: (run, self.makers[run["maker"]]) for name, run in zip(results, self.runs)}


def _record_reference(monkeypatch, jev, rec):
    for kind, name in (("desk", "make_desk"), ("adversarial", "make_adversarial"), ("room", "make_room")):
        monkeypatch.setattr(jsyn, name, rec.scene(kind))

    def synth_rgbd(cfg, scene, poses, rng, adversarial=False, blur=True, noise_sigma=3.0, exposure=(0.55, 1.7)):
        assert (blur, noise_sigma, exposure) == (True, 3.0, (0.55, 1.7))
        return list(zip(*rec.frames(scene, poses, ("rgbd", _seed(rng)) if adversarial else None)))

    def synth_mono(cfg, scene, poses, rng, adversarial=False):
        return [(f, None) for f in rec.frames(scene, poses, ("mono", _seed(rng)) if adversarial else None, False)[0]]

    def synth_stereo(cfg, scene, poses, rng, adversarial=False):
        return list(zip(*rec.frames(scene, poses, ("stereo", _seed(rng)) if adversarial else None)))

    for name, fn in (("synth_rgbd", synth_rgbd), ("synth_mono", synth_mono), ("synth_stereo", synth_stereo),
                     ("run_sequence", rec.run_sequence)):
        monkeypatch.setattr(jev, name, fn)


def _record_port(monkeypatch, rec):
    dolly_pose = synthetic.dolly_pose
    for kind, name in (("desk", "make_desk"), ("adversarial", "make_adversarial"), ("room", "make_room")):
        monkeypatch.setattr(synthetic, name, rec.scene(kind))

    def desk_frames(cfg, poses, device=None, scene=None):
        assert scene is not None
        gt = np.stack(_norm(poses))
        imgs, deps = rec.frames(scene, gt, None)
        return imgs, deps, gt

    def adversarial_frames(cfg, scene, poses, rng, mode):
        return rec.frames(scene, poses, (mode, _seed(rng)), mode != "mono")

    def stereo_dolly_frames(cfg, steps, rng, device=None, dx=0.05, dz=0.04):
        gt = np.stack([dolly_pose(i, dx, dz) for i in steps])
        left, right = rec.frames(("room", _seed(rng), None), gt, None)
        return left, right, gt

    for name, fn in (("desk_frames", desk_frames), ("adversarial_frames", adversarial_frames),
                     ("stereo_dolly_frames", stereo_dolly_frames)):
        monkeypatch.setattr(synthetic, name, fn)
    monkeypatch.setattr(evaluate, "run_sequence", rec.run_sequence)


@pytest.mark.parametrize("quick", [True, False])
def test_evaluate_synthetic_legs(monkeypatch, jevaluate, quick):
    ref_rec, got_rec = LegRecorder(), LegRecorder()
    _record_reference(monkeypatch, jevaluate, ref_rec)
    ref_results, ref_checks = jevaluate.evaluate_synthetic(40, quick=quick)
    _record_port(monkeypatch, got_rec)
    got_results, got_checks = evaluate.evaluate_synthetic(40, quick=quick, device="cpu")

    names = ["clean_desk_rgbd", "adv_clutter_rgbd", "clean_mono", "adv_mono"]
    names += [] if quick else ["stereo_dolly", "adv_stereo_dolly"]
    assert list(ref_results) == list(got_results) == names
    assert got_results == ref_results
    assert got_checks == ref_checks
    assert list(got_checks) == list(ref_checks)
    ref_legs, got_legs = ref_rec.legs(ref_results), got_rec.legs(got_results)
    for name in names:
        (rr, rm), (gr, gm) = ref_legs[name], got_legs[name]
        for key in ("cfg", "sensor", "n", "second", "ts", "align_scale", "async"):
            assert gr[key] == rr[key], (name, key)
        assert sorted(gr["gt"]) == sorted(rr["gt"]), name
        for t in rr["gt"]:
            np.testing.assert_allclose(gr["gt"][t], rr["gt"][t], atol=1e-5, err_msg=name)
        assert gm["scene"] == rm["scene"] and gm["degrade"] == rm["degrade"], name
        assert len(gm["poses"]) == len(rm["poses"]) == gr["n"], name
        np.testing.assert_allclose(np.stack(gm["poses"]), np.stack(rm["poses"]), atol=1e-5, err_msg=name)
    # The mono legs' frame count at --frames 40 is max(40 * 2 // 3, 40).
    assert got_legs["clean_mono"][0]["n"] == 40


# ---------------------------------------------------------------------------
# (b) bench: main's line, the online and KITTI legs, the headline
# ---------------------------------------------------------------------------
ONLINE_OUT = {"online_fps": 7.12, "online_p50_ms": 81.3, "online_p90_ms": 300.2, "online_p99_ms": 612.0,
              "online_max_ms": 900.5, "online_loops": 1, "online_kf": 22, "online_resets": 0}
KITTI_OUT = {"kitti_fps": 5.5, "kitti_p50_ms": 140.1, "kitti_p99_ms": 1500.3}


def test_bench_main_line(monkeypatch, jbench):
    calls = {"ref": {}, "port": {}}

    def recorders(side, array):
        c = calls[side]

        def orbit_frames(cfg, n, *a, **kw):
            c["orbit"] = (dataclasses.asdict(cfg), n)
            z = array(n)
            return (z, z) if side == "ref" else (z, z, np.zeros((n, 4, 4)))

        def headline(cfg, imgs, deps, *a, **kw):
            c["headline"] = (dataclasses.asdict(cfg), imgs.shape[0])
            return 12.3456, 0.04321

        def online_leg(cfg, frames, *a, **kw):
            c["online"] = (dataclasses.asdict(cfg), len(frames))
            return dict(ONLINE_OUT)

        def kitti_leg(*a, **kw):
            c["kitti"] = True
            return dict(KITTI_OUT)

        return orbit_frames, headline, online_leg, kitti_leg

    lines = {}
    for side, mod, array in (("ref", jbench, lambda n: np.zeros((n, 2, 2), np.float32)),
                             ("port", bench, lambda n: torch.zeros((n, 2, 2)))):
        orbit_frames, headline, online_leg, kitti_leg = recorders(side, array)
        monkeypatch.setattr(mod if side == "ref" else synthetic, "orbit_frames", orbit_frames)
        for name, fn in (("headline", headline), ("online_leg", online_leg), ("kitti_leg", kitti_leg)):
            monkeypatch.setattr(mod, name, fn)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main() if side == "ref" else mod.main(device="cpu")
        lines[side] = buf.getvalue().strip().splitlines()[-1]
    ref, got = calls["ref"], calls["port"]
    assert got["orbit"] == ref["orbit"] and ref["orbit"] == (dataclasses.asdict(config.SlamConfig(**BENCH_KW)), 321)
    assert got["headline"] == ref["headline"] == (ref["orbit"][0], 321)
    assert got["online"] == ref["online"] == (dict(ref["orbit"][0], fps=30.0), 321)
    assert got["kitti"] and ref["kitti"]
    ref_line, got_line = json.loads(lines["ref"]), json.loads(lines["port"])
    assert list(got_line) == list(ref_line)
    assert got_line == ref_line
    assert got_line["metric"] == "rgbd_slam_fps_with_loop_closing" and got_line["value"] == 12.35


class FakeSystem:
    """A recording stand-in for either package's `SlamSystem`."""

    made = []

    def __init__(self, config, sensor, async_mapping=False, pipelined=False, device=None, **kw):
        self.rec = {"config": dataclasses.asdict(config), "sensor": sensor.name, "async": async_mapping,
                    "pipelined": pipelined, "warmup": None, "ts": [], "flush": 0, "shutdown": 0}
        self.n_loops_closed, self.n_kf_host, self.n_resets = 2, 17, 0
        self.trajectory = SimpleNamespace(entries=[])
        self.device = torch.device("cpu")
        FakeSystem.made.append(self)

    def warmup(self, **kw):
        self.rec["warmup"] = kw

    def _track(self, a, b, timestamp):
        self.rec["ts"].append(timestamp)
        self.trajectory.entries.append(SimpleNamespace(lost=False))

    track_rgbd = track_stereo = _track

    def flush(self):
        self.rec["flush"] += 1

    def stats(self):
        return {}

    def shutdown(self):
        self.rec["shutdown"] += 1


def _fake_systems(monkeypatch):
    FakeSystem.made = []
    monkeypatch.setattr(jsystem, "SlamSystem", FakeSystem)
    monkeypatch.setattr(bench, "SlamSystem", FakeSystem)


def test_bench_online_leg(monkeypatch, jbench):
    _fake_systems(monkeypatch)
    kw = dict(BENCH_KW, fps=30.0)
    frames = [(None, None)] * 9
    ref_out = jbench.online_leg(jconfig.SlamConfig(**kw), frames)
    got_out = bench.online_leg(config.SlamConfig(**kw), frames, device="cpu")
    (ref,), (got,) = [s.rec for s in FakeSystem.made[:1]], [s.rec for s in FakeSystem.made[1:]]
    assert got == ref
    assert ref["sensor"] == "RGBD" and ref["async"] and ref["pipelined"] and ref["warmup"] == {}
    assert ref["ts"] == [i / 30.0 for i in range(9)] and ref["shutdown"] == 1 and ref["flush"] >= 1
    assert list(got_out) == list(ref_out) == list(ONLINE_OUT)
    assert [got_out[k] for k in ("online_loops", "online_kf", "online_resets")] == [2, 17, 0]
    assert [ref_out[k] for k in ("online_loops", "online_kf", "online_resets")] == [2, 17, 0]


def test_bench_kitti_leg(monkeypatch, jbench):
    _fake_systems(monkeypatch)
    renders, rooms, dollies = [], [], []
    dolly_pose = synthetic.dolly_pose

    def make_room(rng, *a, **kw):
        rooms.append(_seed(rng))
        return "room"

    def render(scene, Tcw, K, width, height):
        renders.append(np.asarray(Tcw, np.float64))
        return jnp.zeros((2, 2)), jnp.zeros((2, 2))

    def stereo_dolly_frames(cfg, steps, rng, device=None, dx=0.05, dz=0.04):
        steps = list(steps)
        dollies.append((dataclasses.asdict(cfg), _seed(rng)))
        left = np.stack([dolly_pose(i, dx, dz) for i in steps]).astype(np.float64)
        right = left.copy()
        right[:, 0, 3] -= cfg.bf / cfg.fx
        dollies.append((left, right))
        z = torch.zeros((len(steps), 2, 2))
        return z, z, left

    monkeypatch.setattr(jsyn, "make_room", make_room)
    monkeypatch.setattr(jsyn, "render", render)
    monkeypatch.setattr(synthetic, "stereo_dolly_frames", stereo_dolly_frames)
    ref_out = jbench.kitti_leg()
    got_out = bench.kitti_leg(device="cpu")
    ref, got = FakeSystem.made[0].rec, FakeSystem.made[1].rec
    assert got == ref
    assert ref["sensor"] == "STEREO" and ref["async"] and ref["pipelined"]
    assert ref["warmup"] == {"gba_buckets": (16, 32)} and ref["ts"] == [i * 0.1 for i in range(60)]
    assert ref["config"]["width"] == 1241 and ref["config"]["n_features"] == 2000
    assert dollies[0] == (ref["config"], rooms[0]) and rooms == [3]
    left, right = dollies[1]
    np.testing.assert_array_equal(left, np.stack(renders[0::2]))
    np.testing.assert_allclose(right, np.stack(renders[1::2]), atol=1e-6)
    assert list(got_out) == list(ref_out) == list(KITTI_OUT)


@pytest.mark.parametrize("fault", [None, "tracking", "no_loop"])
def test_bench_headline_runs(monkeypatch, jbench, fault):
    n = 20
    calls = {"ref": [], "port": []}
    closers = {"ref": [], "port": []}

    def closer_maker(side):
        def make_loop_closer(cfg, *a, **kw):
            lc = SimpleNamespace(n_loops_closed=0 if fault == "no_loop" else 1, n_gba_merged=1,
                                 gba_runner=SimpleNamespace(running=False, n_aborted=0))
            closers[side].append(lc)
            return lc
        return make_loop_closer

    def tracker(side):
        def track_sequence_rgbd(imgs, deps, cfg, loop_closer=None, chunk=None, **kw):
            calls[side].append((dataclasses.asdict(cfg), imgs.shape[0], id(loop_closer), chunk))
            ok = np.arange(n) < (0.8 * n if fault == "tracking" else n)
            return np.zeros((n, 4, 4), np.float32), ok, None
        return track_sequence_rgbd

    monkeypatch.setattr(jbench, "make_loop_closer", closer_maker("ref"))
    monkeypatch.setattr(joffline, "track_sequence_rgbd", tracker("ref"))
    monkeypatch.setattr(bench, "make_loop_closer", closer_maker("port"))
    monkeypatch.setattr(offline, "track_sequence_rgbd", tracker("port"))
    seen = []
    runs = {
        "ref": lambda: jbench.headline(jconfig.SlamConfig(**BENCH_KW), np.zeros((n, 2, 2), np.float32),
                                       np.zeros((n, 2, 2), np.float32)),
        "port": lambda: bench.headline(config.SlamConfig(**BENCH_KW), torch.zeros((n, 2, 2)), torch.zeros((n, 2, 2)),
                                       observe=lambda *a: seen.append(a)),
    }
    out = {}
    for side, run in runs.items():
        if fault is None:
            out[side] = run()
        else:
            with pytest.raises(AssertionError):
                run()
    expect = 5 if fault is None else 3  # 2 warm-up runs, then the timed ones up to the first fault
    for side in ("ref", "port"):
        assert len(calls[side]) == len(closers[side]) == expect
        assert len({c[2] for c in calls[side]}) == expect  # a fresh loop closer per run
        assert [c[3] for c in calls[side]] == [32] * expect
    assert [c[:2] for c in calls["port"]] == [c[:2] for c in calls["ref"]]
    if fault is None:
        assert len(seen) == 3
        for fps, spread in out.values():
            assert np.isfinite(fps) and fps > 0 and spread >= 0


# ---------------------------------------------------------------------------
# (c) evaluate --tum, (d) run_sequence on the desk
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tum_desk")
    (root / "desk.yaml").write_text(SETTINGS)
    cfg = config.load_settings(root / "desk.yaml")
    imgs, deps, gt = synthetic.desk_frames(cfg, synthetic.desk_trajectory(150)[:TUM_FRAMES], device="cpu")
    datasets.write_tum_rgbd(root / "seq", imgs.numpy(), deps.numpy(), gt)
    return root


def test_evaluate_tum_parity(tum_dir, tmp_path, jevaluate):
    pytest.importorskip("PIL.Image")  # the reference's PNG reader
    args = ["--cpu", "--tum", str(tum_dir / "seq"), "--settings", str(tum_dir / "desk.yaml")]
    rcs, evals = {}, {}
    for side, main in (("ref", jevaluate.main), ("port", evaluate.main)):
        out = tmp_path / f"{side}.json"
        with contextlib.redirect_stdout(io.StringIO()):
            rcs[side] = main(args + ["--out", str(out)])
        evals[side] = json.loads(out.read_text())
    ref, got = evals["ref"], evals["port"]
    assert rcs["port"] == rcs["ref"]
    assert list(got) == list(ref) and got["source"] == ref["source"] == "tum"
    assert list(got["sequences"]) == list(ref["sequences"]) == ["tum_rgbd"]
    r, g = ref["sequences"]["tum_rgbd"], got["sequences"]["tum_rgbd"]
    assert list(g) == list(r)
    assert list(got["gates"]["tum_rgbd"]) == list(ref["gates"]["tum_rgbd"])
    assert g["frames"] == r["frames"] == g["tracked"] == TUM_FRAMES
    assert (g["tracked"], g["n_kf"], g["n_resets"]) == (r["tracked"], r["n_kf"], r["n_resets"])
    assert np.isfinite(g["ate_rmse_m"]) and abs(g["ate_rmse_m"] - r["ate_rmse_m"]) <= 2e-3
    assert got["gates"]["tum_rgbd"]["bound"] == ref["gates"]["tum_rgbd"]["bound"]
    assert got["all_pass"] == ref["all_pass"] == (rcs["port"] == 0)


def test_run_sequence_parity(tum_dir, jevaluate):
    cfg = config.load_settings(tum_dir / "desk.yaml")  # the TUM test's camera: its compiled programs are reused
    jcfg = jconfig.SlamConfig(**dataclasses.asdict(cfg))
    imgs, deps, gt = synthetic.desk_frames(cfg, synthetic.desk_trajectory(150)[:SEQ_FRAMES], device="cpu")
    ts = [i * 0.1 for i in range(SEQ_FRAMES)]
    gt_twc = {t: np.linalg.inv(T) for t, T in zip(ts, gt)}
    ref = jevaluate.run_sequence(jcfg, jsystem.Sensor.RGBD,
                                 [(jnp.asarray(i.numpy()), jnp.asarray(d.numpy())) for i, d in zip(imgs, deps)],
                                 ts, gt_twc)
    got = evaluate.run_sequence(cfg, system.Sensor.RGBD, list(zip(imgs, deps)), ts, gt_twc, device="cpu")
    assert list(got) == list(ref)
    assert got["frames"] == ref["frames"] == SEQ_FRAMES
    assert (got["tracked"], got["n_kf"], got["n_resets"]) == (ref["tracked"], ref["n_kf"], ref["n_resets"])
    assert got["tracked"] == SEQ_FRAMES
    assert abs(got["ate_rmse_m"] - ref["ate_rmse_m"]) <= 2e-3


# ---------------------------------------------------------------------------
# (e) the card by default, (f) the port's vocabulary
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("module, args", [("evaluate", ["--quick", "--frames", "4"]), ("bench", [])])
def test_entry_point_without_cpu_needs_a_card(module, args, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start")
    proc = subprocess.run([sys.executable, "-m", f"orb_slam2v2_1_tpu_torch.{module}", *args],
                          cwd=tmp_path, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not list(tmp_path.iterdir())  # nothing written


def test_vocabulary_is_the_packages_own_copy():
    ref = np.load(jvocab.__file__.replace("ops/vocab.py", "data/vocab.npz"))
    got = np.load(system.VOCAB_NPZ)
    pkg = os.path.dirname(os.path.abspath(system.__file__.replace("models/system.py", "__init__.py")))
    assert os.path.dirname(os.path.abspath(system.VOCAB_NPZ)) == os.path.join(pkg, "data")
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        assert '"data/*.npz"' in f.read()


def test_system_has_vocabulary_and_loop_closer():
    cfg = config.SlamConfig(fx=275.0, fy=275.0, cx=160.0, cy=120.0, width=320, height=240, n_features=700,
                            max_keyframes=16, max_map_points=4096, bf=44.0)
    slam = system.SlamSystem(config=cfg, sensor=system.Sensor.RGBD, device="cpu")
    try:
        assert slam.vocab is not None and slam.vocab.n_words > 0
        assert slam.kf_db is not None and slam.loop_closer is not None
        assert slam.loop_closer.vocab is slam.vocab
    finally:
        slam.shutdown()
