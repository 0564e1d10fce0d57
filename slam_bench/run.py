"""The benchmark of the SLAM port (`orb_slam2v2_1_tpu_torch`): one run of one cell.

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for
(it exits with 2 and prints no result without them). The cell's
configuration, traffic, limits and metric readers are found by name
(`manifest.py`), and every name the cell uses (its sensor, its camera path,
each limit's number) is resolved before the card is touched. The run renders
one session's frames from the seed, builds and warms up the system, measures
for `--seconds` (`window.py`), shuts the system down, checks what it
produced against the plain reference (`check.py`) and prints, as the last
line of standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its per-layer
metrics, read from a profiled stretch of the window, `trace.py`), `device`,
with `--trace 1` `breakdown`, and last `checked`, each compared number
beside its limit. The log, the set-up split and the compared numbers go to
standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Whole top-level module names that no run may load: the JAX package is the
# port's name without its suffix, so names are compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam2v2_1_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def set_tf32(on: bool):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    return out.splitlines()[0] if out else "not measured"


def resolve(man, cell_name: str) -> SimpleNamespace:
    """Every piece the cell names, found before any set-up: its
    configuration, traffic and limits, its sensor's entry of `sensors.py`,
    its camera path's function and the `number(ctx)` function of each limit
    that `check.py` does not compute. A name that resolves to nothing raises
    a ValueError naming the file looked for."""
    from . import check, sensors, stream

    cell = man.cell(cell_name)
    config, traffic, limits = man.config(cell["config"]), man.traffic(cell["traffic"]), man.limits(cell_name)
    sensors.spec(config["sensor"], f"slam_bench/configs/{cell['config']}.json")
    if traffic["sensor"] != config["sensor"]:
        raise ValueError(f"slam_bench/traffic/{cell['traffic']}.json feeds a {traffic['sensor']} camera; "
                         f"slam_bench/configs/{cell['config']}.json is {config['sensor']}")
    poses = stream.path_function(traffic["path"]["kind"], man.here)
    checks = {name: man.check(name) for name in limits if name not in check.NUMBERS}
    return SimpleNamespace(cell=cell, config=config, traffic=traffic, limits=limits, poses=poses, checks=checks)


def run_cell(man, cell_name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t_start: float = T_START, tf32: bool = False) -> dict:
    """One run of the cell; returns the result object. `tf32=True` runs the
    program with TF32 on (the control of the correctness check)."""
    import torch

    from . import check, stream, trace, window

    parts = resolve(man, cell_name)
    cell, config, traffic = parts.cell, parts.config, parts.traffic
    slam_cfg, sensor = config["slam"], config["sensor"]
    cuda = device.startswith("cuda")
    marks = [("start", t_start), ("import torch", time.perf_counter())]

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
    mark("CUDA init")
    from orb_slam2v2_1_tpu_torch import kernels
    from orb_slam2v2_1_tpu_torch.runtime import native

    mark("import the port")
    if cuda:
        kernels.build()
    native.load()
    mark("kernels and runtime built or loaded")
    sess = stream.render_session(slam_cfg, sensor, traffic, seed, device, parts.poses)
    mark("render")
    set_tf32(tf32)
    slam = window.build_system(slam_cfg, sensor, device)
    try:
        mark("system and vocabulary")
        wk = traffic["warmup"]
        slam.warmup(gba_buckets=tuple(wk["gba_buckets"]), fuse_buckets=tuple(tuple(b) for b in wk["fuse_buckets"]))
        mark("warm-up")
        if cuda:
            torch.cuda.synchronize()
        win = window.start(slam, traffic["rate_hz"], seconds)
        first = traffic.get("preroll", 0)
        window.preroll(win, slam, sess, sensor, first)
        mark(f"preroll ({first} frames)")
        tracer = trace.Stretch(traffic["trace"]) if traced else None
        gc.collect()
        gc.freeze()  # set-up's objects out of the collector's way inside the window
        counters_start = window.counters()
        stages = window.Stages(slam)
        t_window = time.perf_counter()
        window.drive(win, slam, sess, sensor, tracer, first, stages)
        counters_end = window.counters()
        stages.gather()
        stage = stages.samples()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        slam.flush()  # frames in flight at the close: late, not missing
    finally:
        slam.shutdown()
    set_tf32(False)
    maps = win.maps + [{f: getattr(slam.map, f) for f in window.MAP_FIELDS}]
    del slam
    gc.unfreeze()
    gc.collect()

    setup_s = t_window - t_start
    split = ", ".join(f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(marks, marks[1:]))
    log(f"setup {setup_s:.2f} s: {split}")
    lat = win.in_window()
    trace_frames = None
    if tracer is not None and tracer.summary is not None:
        off = tracer.offset_ns
        trace_frames = sum(1 for t, _ in win.published.values() if tracer.t0 <= t * 1e9 + off <= tracer.t1)
    first_pose = win.first_pose()
    attempted = win.attempted()
    failed = sum(1 for key in attempted
                 if key in win.published and win.published[key][1] is None and key[1] > first_pose.get(key[0], 1e9))
    run = SimpleNamespace(
        seconds=seconds, setup_s=setup_s, latencies_s=list(lat.values()), attempted=len(attempted),
        counters_start=counters_start, counters_end=counters_end, stage_ms=stage,
        trace=tracer.summary if tracer is not None else None, trace_frames=trace_frames, slam_cfg=slam_cfg)
    log(f"window {seconds} s: {len(attempted)} frames submitted in {win.session + 1} session(s), "
        f"{len(lat)} published in the window, {failed} lost; closures published at (session, frame) "
        f"{win.loops_at}; stage samples in the window map {window.count(stage['map'])} loop "
        f"{window.count(stage['loop'])}; reads {counters_end['reads']}; launches {counters_end['launches']}")

    correct, rows, numbers = check.judge(win, maps, sess, config, parts.limits, seed, parts.checks)
    log(f"numbers of the check: {numbers}")
    if not lat:
        correct = False
    metrics = {}
    for m in man.metrics(cell_name, traced):
        value = man.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(attempted), "failed": failed, "metrics": metrics,
              "device": dev}
    if run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace["busy_s"], run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"], "idle_gaps": run.trace["idle_gaps"]}
    result["checked"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    del sess
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # One process with few threads: no CPU thread pool spins beside the
    # tracker and the workers (the program's CPU-side arithmetic is small).
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    # Every build and kernel cache stays at a fixed place inside the checkout.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)

    from .manifest import Manifest

    man = Manifest()
    cell = man.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"{torch.cuda.get_device_name(0)}: {card_line()}")
    result = run_cell(man, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded modules it must not: {bad}")
        return 3
    for name, c in result["checked"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
