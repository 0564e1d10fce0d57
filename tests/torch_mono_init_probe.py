#!/usr/bin/env python3
"""Where the two-view initialization succeeds on `evaluate.py`'s adversarial
monocular leg, in both packages, on the CPU.

    python3 tests/torch_mono_init_probe.py [--frames 40 100] [--card] [--out FILE]

For each frame count n, the adv_mono leg's frames are rendered once by the
port's renderer on the CPU (`make_adversarial(default_rng(22),
max_tilt_deg=35)` along `lateral_trajectory(n, extent=0.9)` made relative to
its first camera, degraded with `default_rng(33)`, bf=0: what `evaluate.py`
and `python -m orb_slam2v2_1_tpu_torch.evaluate` feed it) and go through
three sync `SlamSystem(sensor=MONOCULAR)` runs:
  - the reference (JAX on the CPU) with its own RANSAC draws;
  - the port on the CPU with its own draws (`ops/prng.py` from the
    reference's key, `key(frame id)`);
  - the port on the CPU with the reference's sampler injected on the same
    keys, as `tests/test_torch_mono.py` injects it.
With `--card`, the port also runs on the NVIDIA card on the same frames with
its own draws and with the reference's sampler injected; and once on the
leg's frames rendered and degraded on the card, as the evaluate entry point
feeds them there.
Each run prints every initialization attempt (frame, level-0 matches to the
reference frame, success), the first pose, the tracked count and the
scale-aligned ATE (`run_sequence`'s counting). Runs at the evaluate
configuration (640x480), so it takes minutes and a few GiB. Not a test:
pytest does not collect this file.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from orb_slam2v2_1_tpu.models import initialization as jinit  # noqa: E402
from orb_slam2v2_1_tpu.models import system as jsystem  # noqa: E402
from orb_slam2v2_1_tpu.ops import twoview as jtv  # noqa: E402
from orb_slam2v2_1_tpu.utils import config as jconfig  # noqa: E402
from orb_slam2v2_1_tpu.utils.trajectory import ate_rmse  # noqa: E402
from orb_slam2v2_1_tpu_torch import kernel_times  # noqa: E402
from orb_slam2v2_1_tpu_torch.models import initialization as tinit  # noqa: E402
from orb_slam2v2_1_tpu_torch.models import system as tsystem  # noqa: E402
from orb_slam2v2_1_tpu_torch.ops import twoview  # noqa: E402
from orb_slam2v2_1_tpu_torch.utils import config, synthetic  # noqa: E402

KW = dict(kernel_times.EVAL, bf=0.0)


def frames_of(n, device="cpu"):
    poses = synthetic.lateral_trajectory(n, extent=0.9)
    poses = [p @ np.linalg.inv(poses[0]) for p in poses]
    scene = synthetic.make_adversarial(np.random.default_rng(22), max_tilt_deg=35.0, device=device)
    imgs, _ = synthetic.adversarial_frames(config.SlamConfig(**KW), scene, poses, np.random.default_rng(33), "mono")
    return imgs, poses


def host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def run(name, slam, init_mod, imgs, poses):
    attempts = []
    match = init_mod.match_for_initialization
    initialize = slam._initialize

    def counted_match(ref, frame):
        m = match(ref, frame)
        attempts.append({"frame": slam.frame_id, "matches": int(host(m.ok).sum()), "success": False})
        return m

    def logged_initialize(frame):
        ok = initialize(frame)
        if ok and attempts and attempts[-1]["frame"] == slam.frame_id:
            attempts[-1]["success"] = True
        return ok

    init_mod.match_for_initialization = counted_match
    slam._initialize = logged_initialize
    try:
        t0 = time.time()
        for i, img in enumerate(imgs):
            slam.track_monocular(img, i * 0.1)
        wall = time.time() - t0
    finally:
        init_mod.match_for_initialization = match
    entries = slam.trajectory.entries
    tracked = sum(not e.lost for e in entries)
    first = next((round(e.timestamp * 10) for e in entries if not e.lost), None)
    est = slam.trajectory.absolute_poses(host(slam.map.kf_pose))
    ate = ate_rmse(est, {i * 0.1: np.linalg.inv(T) for i, T in enumerate(poses)}, align_scale=True)
    rec = {"run": name, "frames": len(imgs), "tracked": tracked, "first_pose_frame": first, "keyframes": slam.n_kf_host,
           "ate_m": ate, "wall_s": wall, "attempts": [a for a in attempts if a["matches"] >= 70]}
    print(f"  {name}: {tracked}/{len(imgs)} tracked, first pose at frame {first}, {slam.n_kf_host} keyframes, "
          f"ATE {ate:.5f} m scale-aligned, {wall:.1f} s; two-view attempts (frame, matches, success): "
          f"{[(a['frame'], a['matches'], a['success']) for a in rec['attempts']]}", flush=True)
    return rec


def port_run(name, device, imgs, poses, reference_sampler=False):
    """The port's SlamSystem on `device`; with `reference_sampler` the
    reference's `_sample_sets` replaces the port's on the same key (a half
    of the split of key(frame id))."""
    real = twoview.sample_sets

    def replaced(valid, key, k=8):
        jkey = jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32))
        sets = np.array(jtv._sample_sets(jkey, jnp.asarray(valid.cpu().numpy()), jtv.N_RANSAC, k))
        return torch.from_numpy(sets.astype(np.int64)).to(valid.device)

    if reference_sampler:
        twoview.sample_sets = replaced
    try:
        return run(name, tsystem.SlamSystem(config=config.SlamConfig(**KW), sensor=tsystem.Sensor.MONOCULAR,
                                            device=device), tinit, imgs, poses)
    finally:
        twoview.sample_sets = real


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, nargs="+", default=[40, 100])
    p.add_argument("--card", action="store_true", help="also run the port on the NVIDIA card")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    out = []
    for n in args.frames:
        imgs, poses = frames_of(n)
        imgs = imgs.numpy()
        print(f"adv_mono at {n} frames:", flush=True)
        recs = [run("reference (JAX, CPU), its draws",
                    jsystem.SlamSystem(config=jconfig.SlamConfig(**KW), sensor=jsystem.Sensor.MONOCULAR),
                    jinit, [jnp.asarray(i) for i in imgs], poses),
                port_run("port (CPU), its draws", "cpu", imgs, poses),
                port_run("port (CPU), the reference's sampler", "cpu", imgs, poses, True)]
        if args.card:
            recs += [port_run("port (card), its draws", "cuda", imgs, poses),
                     port_run("port (card), the reference's sampler", "cuda", imgs, poses, True)]
            card_imgs, _ = frames_of(n, "cuda")
            diff = float((card_imgs.cpu() - torch.from_numpy(imgs)).abs().max())
            print(f"  frames rendered on the card: max |card - CPU| {diff} gray levels", flush=True)
            recs.append(dict(port_run("port (card), its draws, frames rendered on the card", "cuda", card_imgs, poses),
                             max_frame_diff=diff))
        out += [dict(r, n_frames=n) for r in recs]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=float)


if __name__ == "__main__":
    main()
