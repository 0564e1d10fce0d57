#!/usr/bin/env python3
"""Relocalization gaps between the packages when both draw the same RANSAC
sets, on the CPU.

    python3 tests/torch_reloc_gap_probe.py [--out FILE]

1. On the map and BoW database the reference built from orbit frames 0-15 at
   320x240 (`test_torch_reloc.py reference_map`), for each query and each
   live keyframe as the candidate: both packages' `_match_and_pnp`, the port
   drawing from `prng.key(frame_id * 97 + kf)`, the reference from
   `jax.random.key` of the same seed: inlier counts, the pose gap (mm, deg)
   where both reach 50, and the candidates that reach 50 in one package
   only; then each query's `relocalize` in both: keyframe and pose gap.
2. `test_blackout_then_relocalization`'s frames through both `SlamSystem`s:
   the pose gap at frame 27, before the blackout, and at the relocalized
   frame 30.
Prints one JSON object (with --out also to FILE). Not a test: pytest does
not collect this file. JAX runs on the CPU; a few minutes on 2 threads.
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import test_torch_reloc as tr  # noqa: E402

from orb_slam2v2_1_tpu.models import relocalization as jreloc  # noqa: E402
from orb_slam2v2_1_tpu_torch.models import relocalization  # noqa: E402
from orb_slam2v2_1_tpu_torch.ops import prng  # noqa: E402


def gap(a, b):
    return [float(x) for x in tr._gap(np.asarray(a), np.asarray(b))]


def main():
    args = sys.argv[1:]
    if args and not (len(args) == 2 and args[0] == "--out"):
        raise SystemExit(__doc__)
    b = tr.reference_map()
    bf = jnp.float32(b["bf"])
    candidates, relocalized = [], []
    for query in tr.QUERIES:
        jf, tf = b["queries"][query]
        fid = query[1]
        for kf in range(int(np.asarray(b["jstate"].kf_valid).sum())):
            ref = jreloc._match_and_pnp(b["jstate"], jf, jnp.int32(kf), b["K"], bf, jax.random.key(fid * 97 + kf))
            got = relocalization._match_and_pnp(b["tstate"], tf, kf, b["tK"], b["bf"], prng.key(fid * 97 + kf))
            row = {"query": list(query), "kf": kf, "inliers_port_ref": [int(got[3]), int(ref[3])]}
            if int(got[3]) >= 50 and int(ref[3]) >= 50:
                row["gap_mm_deg"] = gap(got[1], ref[1])
            candidates.append(row)
        ref = jreloc.relocalize(b["jstate"], b["jdb"], b["jvoc"], jf, b["K"], bf, fid)
        got = relocalization.relocalize(b["tstate"], b["tdb"], b["tvoc"], tf, b["tK"], b["bf"], fid)
        relocalized.append({"query": list(query), "ok_port_ref": [bool(got[0]), bool(ref[0])],
                            "kf_port_ref": [got[3], None if ref[3] is None else int(ref[3])],
                            "gap_mm_deg": gap(got[1], ref[1]) if got[0] and ref[0] else None})
    both = [r for r in candidates if "gap_mm_deg" in r]
    one = [r for r in candidates if (r["inliers_port_ref"][0] >= 50) != (r["inliers_port_ref"][1] >= 50)]
    jslam, tslam, jout, tout, _, _ = tr.blackout_runs()
    out = {
        "candidates": len(candidates), "both_reach_50": len(both), "one_only": one,
        "candidate_gap_max_mm_deg": [max(r["gap_mm_deg"][i] for r in both) for i in (0, 1)] if both else None,
        "relocalize": relocalized,
        "blackout": {"tracked_port_ref": [sum(o is not None for o in tout), sum(o is not None for o in jout)],
                     "relocalized_ref_kf_port_ref": [tslam.trajectory.entries[30].ref_kf,
                                                     jslam.trajectory.entries[30].ref_kf],
                     "gap_frame27_mm_deg": gap(tout[27], jout[27]), "gap_frame30_mm_deg": gap(tout[30], jout[30])},
        "per_candidate": candidates,
    }
    print(json.dumps(out))
    if args:
        with open(args[1], "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
