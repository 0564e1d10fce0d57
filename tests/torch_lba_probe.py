#!/usr/bin/env python3
"""A local BA of a saved mapping round through both packages, on the CPU.

    python3 tests/torch_lba_probe.py DIR

DIR holds what `tests/torch_online_repeat.py --events F --lba-dump DIR` saved
on the card: the map before each local BA that moved a keyframe more than
0.5 m (`lba_run<k>_<n>_map.npz`, the reference's format, with the keyframe
in its metadata) and the card's record of that round (`.json`). For each,
on the CPU: the window (free and fixed keyframes, observations, how many of
a free keyframe's observations are of points a fixed keyframe also sees),
the chi2 of every observation at the start against the mono / stereo
thresholds, and the camera moves of the reference's
`local_bundle_adjustment` and of the port's `local_bundle_adjustment_impl`
on the same map. Prints one JSON line per round. Not a test: pytest does
not collect this file. JAX runs on the CPU.
"""

import glob
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    src = sys.argv[1]
    import numpy as np
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    from orb_slam2v2_1_tpu.models import local_mapping as jlm
    from orb_slam2v2_1_tpu.utils import serialization as jser
    from orb_slam2v2_1_tpu_torch.kernel_times import BENCH
    from orb_slam2v2_1_tpu_torch.models import local_mapping
    from orb_slam2v2_1_tpu_torch.ops import ba
    from orb_slam2v2_1_tpu_torch.utils import serialization

    K = np.array([BENCH["fx"], BENCH["fy"], BENCH["cx"], BENCH["cy"]], np.float32)
    bf = float(np.float32(BENCH["bf"]))

    def centers(pose, valid, seq):
        return {int(seq[k]): -pose[k, :3, :3].T @ pose[k, :3, 3] for k in np.nonzero(valid)[0]}

    def moves(before, after, cams):
        return {k: round(float(np.linalg.norm(after[k] - before[k])), 3) for k in cams}

    for f in sorted(glob.glob(os.path.join(src, "lba_run*_map.npz"))):
        card = json.load(open(f[:-len("_map.npz")] + ".json"))
        tstate, meta = serialization.load_map(f, device="cpu")
        kf = int(meta["kf_id"])
        jstate, _ = jser.load_map(f)
        wb = local_mapping.build_local_ba_window(tstate, kf, torch.from_numpy(K), bf)
        win = wb.win
        used = wb.cam_used.numpy()
        free = used & ~win.cam_fixed.numpy()
        seq = tstate.kf_seq[wb.cam_kf].numpy()
        r, behind = ba._window_eval(win.poses, win.points, win)
        chi2 = ba._window_chi2(r, win).numpy()
        th = np.where(win.is_stereo.numpy(), ba.CHI2_STEREO, ba.CHI2_MONO)
        valid = win.valid.numpy()
        pt = win.pt_idx.numpy()
        seen_fixed = np.zeros(win.points.shape[0] + 1, bool)
        for c in np.nonzero(used & ~free)[0]:
            seen_fixed[pt[c][valid[c]]] = True
        per_cam = {int(seq[c]): {"obs": int(valid[c].sum()), "shared_with_fixed": int(seen_fixed[pt[c][valid[c]]].sum()),
                                 "over_threshold": int((valid[c] & (chi2[c] > th[c])).sum()),
                                 "behind": int((valid[c] & behind[c].numpy()).sum()),
                                 "chi2_median": float(np.median(chi2[c][valid[c]])) if valid[c].any() else None}
                   for c in np.nonzero(used)[0]}
        before = centers(tstate.kf_pose.numpy(), tstate.kf_valid.numpy(), tstate.kf_seq.numpy())
        tout, tcost = local_mapping.local_bundle_adjustment_impl(tstate, kf, torch.from_numpy(K), bf)
        jout, jcost = jlm.local_bundle_adjustment(jax.tree.map(jnp.copy, jstate), jnp.int32(kf), jnp.asarray(K),
                                                  jnp.float32(bf))
        cams = [int(s) for s in seq[used]]
        rec = {"file": os.path.basename(f), "kf_seq": int(tstate.kf_seq[kf]), "card_moves": card.get("moves"),
               "free": [int(s) for s in seq[free]], "fixed": [int(s) for s in seq[used & ~free]],
               "per_cam": per_cam,
               "port_moves": moves(before, centers(tout.kf_pose.numpy(), tout.kf_valid.numpy(),
                                                   tout.kf_seq.numpy()), cams),
               "reference_moves": moves(before, centers(np.asarray(jout.kf_pose), np.asarray(jout.kf_valid),
                                                        np.asarray(jout.kf_seq)), cams),
               "port_cost": float(tcost), "reference_cost": float(jcost)}
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
