#!/usr/bin/env python3
"""The JAX reference's numbers for `chip_smoke.py` phases 17 and 18, on the CPU.

    python3 tests/torch_reference_cli_server.py --cli [--sync] [--out FILE]
    python3 tests/torch_reference_cli_server.py --server DIR [--keys N] [--out FILE]

`--cli` writes phase 17's TUM directory (`chip_smoke.write_cli_dataset`: the
desk sweep rendered by the port's renderer on the CPU, RGB and 16-bit depth
PNGs, a settings file) into `build/reference_cli/` and runs the reference's
command line on it as a subprocess, `python -m orb_slam2v2_1_tpu.run_slam
--cpu`, in its default async mode (`--sync`: sync mode): its exit code, the
ATE it prints and its frames/s. The reference reads PNGs with PIL. Twice
this ATE is phase 17's bound.

`--server DIR` takes the two sessions phase 18 leaves in DIR
(`session1.npz`, `session2.npz`: the server's mirrors of what each session
streamed) through the reference: each session's deltas (every live keyframe,
then a pose update) into its `SlamServer`, which merges session 1 into
session 2's world as phase 18 does (`merge_clients(2, 1, K, key(0))`): whether
the merge was accepted, the fused points, and the RMS of session 1's keyframe
centers from the truth in session 2's world. The merge's Sim3 RANSAC draws
its hypotheses from the key, and the RMS depends on the draw (the port with
these sets injected gives the same RMS); `--keys N` repeats the merge with
keys 0..N-1, and twice the median RMS over them is phase 18's bound. Then
its `SlamSystem` (sync, phase 18's configuration) adopts the map merged with
key 0 and is fed phase 18's revisit frames: which get a pose, the keyframe a
relocalization landed on, and the pose's error.

Not a test: pytest does not collect this file. Each mode takes minutes.
"""

import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from orb_slam2v2_1_tpu_torch.kernel_times import EVAL  # noqa: E402
from orb_slam2v2_1_tpu_torch.utils import config as tconfig  # noqa: E402


def cli(sync_mode):
    data_dir = os.path.join(ROOT, "build", "reference_cli")
    yaml = chip_smoke.write_cli_dataset(tconfig.SlamConfig(**EVAL), data_dir, device="cpu")
    cmd = [sys.executable, "-m", "orb_slam2v2_1_tpu.run_slam", "--dataset", os.path.join(data_dir, "seq"),
           "--settings", yaml, "--cpu", "--out", os.path.join(data_dir, "traj.txt")] + (["--sync"] if sync_mode else [])
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=3000)
    wall = time.time() - t0
    ate = re.search(r"ATE RMSE: ([0-9.]+) m", proc.stdout)
    fps = re.search(r"frames in [0-9.]+s \(([0-9.]+) fps\)", proc.stdout)
    return {"path": "cli_run_slam", "package": "orb_slam2v2_1_tpu (JAX, CPU)", "mode": "sync" if sync_mode else "async",
            "frames": chip_smoke.CLI_FRAMES, "returncode": proc.returncode,
            "ate_m": float(ate.group(1)) if ate else None, "fps_printed": float(fps.group(1)) if fps else None,
            "wall_s": wall, "stderr_tail": proc.stderr[-1500:] if proc.returncode else ""}


def server(session_dir, n_keys=1):
    from orb_slam2v2_1_tpu.models import relocalization
    from orb_slam2v2_1_tpu.models.system import Sensor, SlamSystem
    from orb_slam2v2_1_tpu.parallel import server as srv
    from orb_slam2v2_1_tpu.utils import serialization
    from orb_slam2v2_1_tpu.utils.config import SlamConfig

    cfg = SlamConfig(**EVAL)

    def fresh_server():
        # A server per merge: the reference's merge donates buffers its
        # first session's map still holds, so a second merge on one server
        # fails ("Buffer has been deleted or donated").
        jserver = srv.SlamServer(cfg.max_keyframes, cfg.max_map_points, cfg.n_features)
        for cid in (1, 2):
            state, _ = serialization.load_map(os.path.join(session_dir, f"session{cid}.npz"))
            live = np.where(np.asarray(state.kf_valid))[0]
            for k in live:
                jserver.receive(cid, srv.encode_keyframe_delta(state, int(k)))
            jserver.receive(cid, srv.encode_pose_update(state, live))
        return jserver

    jserver = fresh_server()
    n_kf = {cid: int(jserver.client_map(cid).n_kf) for cid in (1, 2)}
    imgs, deps, gt = chip_smoke.two_session_frames(tconfig.SlamConfig(**EVAL), device="cpu")
    g0 = np.linalg.inv(gt[chip_smoke.SESSION_2[0]])
    n1, n2 = n_kf[1], n_kf[2]
    by_key = []
    for key in range(n_keys):
        jserver = jserver if key == 0 else fresh_server()
        t0 = time.time()
        m = jserver.merge_clients(2, 1, jax.numpy.asarray(cfg.K), jax.random.key(key))
        merge_s = time.time() - t0
        if m is None:
            by_key.append({"key": key, "accepted": False, "merge_s": merge_s})
            continue
        kf_valid, kf_pose, kf_frame = (np.asarray(a) for a in (m.kf_valid, m.kf_pose, m.kf_frame_id))
        errs = [chip_smoke._pose_err(kf_pose[n2 + k], gt[chip_smoke.SESSION_1[0] + int(kf_frame[n2 + k])] @ g0)[0]
                for k in range(n1) if kf_valid[n2 + k]]
        by_key.append({"key": key, "accepted": True, "merge_s": merge_s, "merged_keyframes": int(m.n_kf),
                       "fused": int(jserver.last_merge_fused), "session1_center_rms_m": float(np.sqrt(np.mean(
                           np.square(errs)))), "session1_center_max_m": float(max(errs))})
        if key == 0:
            merged = m
    rms = [r["session1_center_rms_m"] for r in by_key if r["accepted"]]
    rec = {"path": "two_sessions", "package": "orb_slam2v2_1_tpu (JAX, CPU)", "session_keyframes": [n1, n2],
           "by_key": by_key, "accepted": by_key[0]["accepted"],
           "session1_center_rms_median_m": float(np.median(rms)) if rms else None}
    if not by_key[0]["accepted"]:
        return rec

    slam = SlamSystem(config=cfg, sensor=Sensor.RGBD)
    buf = io.BytesIO()
    serialization.save_map(merged, buf, metadata={"n_kf_host": int(merged.n_kf), "ref_kf": 0, "frame_id": 0})
    slam._adopt_map_bytes(buf.getvalue())
    relocs, relocalize = [], relocalization.relocalize

    def logged(*a, **k):
        out = relocalize(*a, **k)
        relocs.append(None if out[3] is None else int(out[3]))
        return out

    relocalization.relocalize = logged
    revisit = list(range(*chip_smoke.REVISIT))
    outs = [slam.track_rgbd(imgs[f].numpy(), deps[f].numpy(), (100 + j) * 0.1) for j, f in enumerate(revisit)]
    first = next((j for j, o in enumerate(outs) if o is not None), None)
    rec.update(revisit_frames=revisit, revisit_poses=[o is not None for o in outs], relocalized_on=relocs,
               reloc_err_m_deg=None if first is None else chip_smoke._pose_err(np.asarray(outs[first]),
                                                                             gt[revisit[first]] @ g0))
    return rec


def main():
    args = sys.argv[1:]
    out = args[args.index("--out") + 1] if "--out" in args else None
    if args and args[0] == "--cli":
        record = cli("--sync" in args)
    elif len(args) >= 2 and args[0] == "--server":
        record = server(args[1], int(args[args.index("--keys") + 1]) if "--keys" in args else 1)
    else:
        raise SystemExit(__doc__)
    print(json.dumps(record, default=str), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(record, f, indent=1, default=str)


if __name__ == "__main__":
    main()
