#!/usr/bin/env python3
"""`compute_sim3` of a saved loop round through both packages, on the CPU.

    python3 tests/torch_sim3_probe.py DIR [--out FILE]

DIR holds what `tests/torch_online_repeat.py --sim3-dump DIR` saved on the
card for each `compute_sim3` that failed on a consistent candidate: the map
(`*_map.npz`, the reference's format), the pair and the card's RANSAC
hypothesis sets (`*.npz`). For each, on the CPU:
- the port with the card's sets (does the CPU repeat the card's verdict?);
- the reference with the same sets, injected in place of its Gumbel draw;
- the reference with its own draw (key `kf * 131 + cand`), and the port given
  that draw's sets;
- the BoW matches of the pair in each package.
Prints one JSON line per round (with --out also to FILE). Not a test: pytest
does not collect this file. JAX runs on the CPU.
"""

import glob
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    args = sys.argv[1:]
    src = args[0]
    out = args[args.index("--out") + 1] if "--out" in args else None
    import numpy as np
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    from orb_slam2v2_1_tpu.models import loop_closing as jlc
    from orb_slam2v2_1_tpu.ops import sim3solver as js3
    from orb_slam2v2_1_tpu.ops import vocab as jvocab
    from orb_slam2v2_1_tpu.utils import serialization as jser
    from orb_slam2v2_1_tpu_torch.models import loop_closing as lc
    from orb_slam2v2_1_tpu_torch.models.system import VOCAB_NPZ
    from orb_slam2v2_1_tpu_torch.ops import vocab
    from orb_slam2v2_1_tpu_torch.utils import serialization
    from orb_slam2v2_1_tpu_torch.kernel_times import BENCH

    K = np.array([BENCH["fx"], BENCH["fy"], BENCH["cx"], BENCH["cy"]], np.float32)
    npz = np.load(VOCAB_NPZ)
    jvoc, tvoc = jvocab.load_vocabulary(npz), vocab.load_vocabulary(npz, device="cpu")
    gumbel = jax.random.gumbel

    def injected(sets, n):
        """A stand-in for the reference's Gumbel draw whose top 3 per row are
        `sets`, in order."""
        g = np.full((sets.shape[0], n), -1e30, np.float32)
        for h, row in enumerate(sets):
            g[h, row] = [3.0, 2.0, 1.0]
        return lambda key, shape: jnp.asarray(g)

    def reference(jstate, kf, cand, sets=None):
        jax.random.gumbel = gumbel if sets is None else injected(sets, jstate.kf_xy.shape[1])
        js3.jax.random.gumbel = jax.random.gumbel
        jax.clear_caches()
        try:
            r = jlc.compute_sim3(jstate, jnp.int32(kf), jnp.int32(cand), jnp.asarray(K), jax.random.key(kf * 131 + cand),
                                 fix_scale=True, voc=jvoc)
        finally:
            jax.random.gumbel = gumbel
        return {"success": bool(r[0]), "n_inl": int(r[2]), "n_total": int(r[3])}

    def port(tstate, kf, cand, sets):
        r = lc.compute_sim3(tstate, kf, cand, torch.from_numpy(K), fix_scale=True, voc=tvoc,
                            sets=torch.from_numpy(np.asarray(sets)).long())
        return {"success": bool(r[0]), "n_inl": int(r[2]), "n_total": int(r[3])}

    lines = []
    for f in sorted(glob.glob(os.path.join(src, "sim3_run*_[0-9].npz"))):
        d = np.load(f)
        kf, cand, sets = int(d["kf"]), int(d["cand"]), d["sets"]
        jstate, _ = jser.load_map(f[:-4] + "_map.npz")
        tstate, _ = serialization.load_map(f[:-4] + "_map.npz", device="cpu")
        jm = jlc.match_keyframes(jstate, jnp.int32(kf), jnp.int32(cand), jvoc)
        tm = lc.match_keyframes(tstate, kf, cand, tvoc)
        g = gumbel(jax.random.key(kf * 131 + cand), (js3.N_HYP, jm.ok.shape[0]))
        ref_sets = np.asarray(jax.lax.top_k(jnp.where(jm.ok[None, :], g, -jnp.inf), 3)[1])
        rec = {"file": os.path.basename(f), "kf": kf, "cand": cand,
               "card": {"success": bool(d["success"]), "n_inl": int(d["n_inl"]), "n_total": int(d["n_total"])},
               "bow_matches": {"card": int(d["m_ok"].sum()), "port_cpu": int(tm.ok.sum()),
                               "reference": int(np.asarray(jm.ok).sum())},
               "card_sets": {"port_cpu": port(tstate, kf, cand, sets), "reference": reference(jstate, kf, cand, sets)},
               "reference_draw": {"port_cpu": port(tstate, kf, cand, ref_sets),
                                  "reference": reference(jstate, kf, cand)}}
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    if out:
        with open(out, "w") as fh:
            fh.write("\n".join(json.dumps(r) for r in lines) + "\n")


if __name__ == "__main__":
    main()
