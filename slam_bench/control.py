"""Readings of the correctness check over several seeds in one process.

    python3 -m slam_bench.control --workload <cell> --seeds 1,2,3 --seconds <s> [--tf32]

runs the cell once per seed, as `slam_bench.run` does, and prints one JSON
line per seed with its compared numbers. `--tf32` is the control: the
program computes with TF32 on for matrix products and cuDNN convolutions
(the nearest precision below the configuration's float32), and the check
must come out false. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tf32", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from . import run
    from .manifest import Manifest

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    man = Manifest()
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(man, args.workload, seed, args.seconds, traced=False, t_start=time.perf_counter(),
                           tf32=args.tf32)
        print(json.dumps({"workload": args.workload, "seed": seed, "tf32": args.tf32, "correct": res["correct"],
                          "checked": {k: v["value"] for k, v in res["checked"].items()},
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
