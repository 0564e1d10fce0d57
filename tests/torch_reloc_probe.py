#!/usr/bin/env python3
"""Relocalization in a saved map, through both packages, on the CPU.

    python3 tests/torch_reloc_probe.py MAP.npz FRAMES [--pnp KF]

MAP.npz is a map either package saved (`SlamSystem.save_map`; phase 11's maps
come from `tests/torch_online_repeat.py --out DIR`), FRAMES a comma-separated
list of frames of the benchmark's 321-frame orbit, rendered on the CPU by the
port's renderer. For each frame, a fresh load in each package's `SlamSystem`
(sync mode, the benchmark configuration) tracks it: printed are whether it
relocalized and each candidate keyframe tried with its inlier count, first
with the port's own RANSAC draws and then with the port given the
reference's draws (`jax.random.key(frame_id * 97 + kf)`).

With `--pnp KF`, the first frame is also taken apart against keyframe KF:
the descriptor correspondences of each package (equal or not), the share of
them that agree with their median image displacement, each package's RANSAC
with the reference's key, and how many of 50 six-point DLT hypotheses drawn
from the consistent correspondences alone score 20 inliers. Not a test:
pytest does not collect this file. A frame takes seconds, the JAX side's
first compiles about a minute.
"""

import os
import sys

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from orb_slam2v2_1_tpu.models import relocalization as jrel  # noqa: E402
from orb_slam2v2_1_tpu.models import system as jsys  # noqa: E402
from orb_slam2v2_1_tpu.models import tracking as jtr  # noqa: E402
from orb_slam2v2_1_tpu.ops import hamming as jh  # noqa: E402
from orb_slam2v2_1_tpu.ops import matching as jm  # noqa: E402
from orb_slam2v2_1_tpu.ops import pnp as jpnp  # noqa: E402
from orb_slam2v2_1_tpu.utils import config as jconfig  # noqa: E402
from orb_slam2v2_1_tpu_torch import kernel_times as kt  # noqa: E402
from orb_slam2v2_1_tpu_torch.models import frontend, relocalization, tracking  # noqa: E402
from orb_slam2v2_1_tpu_torch.models import system as tsys  # noqa: E402
from orb_slam2v2_1_tpu_torch.ops import hamming, matching, pnp  # noqa: E402
from orb_slam2v2_1_tpu_torch.utils import config, serialization, synthetic  # noqa: E402

TOTAL = 321


def reference_sets(frame_id, kf, valid):
    key = jax.random.key(frame_id * 97 + kf)
    return torch.as_tensor(np.asarray(jpnp._sample_sets(key, jnp.asarray(valid.numpy()), jpnp.N_HYP, jpnp.SAMPLE)))


def main():
    args = sys.argv[1:]
    if len(args) not in (2, 4) or (len(args) == 4 and args[2] != "--pnp"):
        raise SystemExit(__doc__)
    path, frames = args[0], [int(f) for f in args[1].split(",")]
    pnp_kf = int(args[3]) if len(args) == 4 else None
    cfg = config.SlamConfig(**kt.BENCH)
    rng = np.random.default_rng(11)  # the room of `synthetic.orbit_frames`
    room = synthetic.make_room(rng, device="cpu")
    scene = synthetic.PlaneScene(room.origin[:6], room.ux[:6], room.vy[:6], room.tex[:6])
    K = torch.tensor(cfg.K, dtype=torch.float32)

    tried = []
    port_mp, ref_mp = relocalization._match_and_pnp, jrel._match_and_pnp

    def port_logged(state, frame, kf, *a, **k):
        out = port_mp(state, frame, kf, *a, **k)
        tried.append(("port", int(kf), int(out[3])))
        return out

    def ref_logged(state, frame, kf, *a, **k):
        out = ref_mp(state, frame, kf, *a, **k)
        tried.append(("reference", int(kf), int(out[3])))
        return out

    relocalization._match_and_pnp, jrel._match_and_pnp = port_logged, ref_logged
    port_reloc = relocalization.relocalize
    use_ref_sets = [False]

    def port_relocalize(state, db, voc, frame, K_, bf, frame_id, sets=None):
        if use_ref_sets[0]:
            sets = lambda kf, valid: reference_sets(frame_id, kf, valid)  # noqa: E731
        return port_reloc(state, db, voc, frame, K_, bf, frame_id, sets=sets)

    relocalization.relocalize = port_relocalize
    tslam = tsys.SlamSystem(config=cfg, sensor=tsys.Sensor.RGBD, device="cpu")
    jslam = jsys.SlamSystem(config=jconfig.SlamConfig(**kt.BENCH), sensor=jsys.Sensor.RGBD)
    imgs = {}
    for f in frames:
        img, dep = synthetic.render(scene, torch.from_numpy(synthetic.orbit_pose(f, TOTAL)), K, cfg.width, cfg.height)
        imgs[f] = (img, dep)
        line = []
        for label, ref_sets in (("own draws", False), ("reference's draws", True)):
            use_ref_sets[0] = ref_sets
            tried.clear()
            tslam.load_map(path)
            r0 = tslam.n_relocalized
            tslam.track_rgbd(img, dep, 20.0 + f / 30)
            line.append(f"port ({label}) relocalized {tslam.n_relocalized > r0} tried {tried[:]}")
        tried.clear()
        jslam.load_map(path)
        jslam.track_rgbd(img.numpy(), dep.numpy(), 20.0 + f / 30)
        line.append(f"reference relocalized {jslam.state == jsys.TrackState.OK} tried {tried[:]}")
        print(f"frame {f}: " + "; ".join(line), flush=True)
    if pnp_kf is not None:
        take_apart(path, frames[0], pnp_kf, imgs[frames[0]], tslam, jslam, cfg)


def take_apart(path, f, kf, img_dep, tslam, jslam, cfg):
    """The correspondences and the RANSAC of frame f against keyframe kf."""
    from orb_slam2v2_1_tpu.utils import serialization as jser

    img, dep = img_dep
    state, meta = serialization.load_map(path, device="cpu")
    fid = int(meta.get("frame_id", 0))
    frame = frontend.build_frame_only(img, dep, tslam._K, tslam._dist, tslam._bf, fid, tslam._orb_cfg, cfg.width,
                                      cfg.height)
    N = frame.xy.shape[0]
    kf_mp = state.kf_mp[kf]
    kf_has = (kf_mp >= 0) & state.kf_kp_valid[kf]
    m = matching.match_nn(hamming.unpack_pm1(state.kf_desc[kf]), frame.desc_pm1, kf_has[:, None] & frame.kp_valid[None, :],
                          max_dist=matching.TH_LOW, nn_ratio=0.75)
    m = matching.resolve_duplicates(m.idx, m.dist, m.ok, N)
    frame_mp = tracking._associate(N, m.ok, m.idx, kf_mp)
    has = frame_mp >= 0
    pw = state.mp_pos[torch.clamp(frame_mp, min=0).long()]
    inv_s2 = tracking.inv_level_sigma2("cpu")[torch.clamp(frame.level, 0, tracking.N_LEVELS - 1).long()]

    jstate, _ = jser.load_map(path)
    jf = jslam_frame(jslam, img, dep, fid, cfg)
    jhas_kf = (jstate.kf_mp[kf] >= 0) & jstate.kf_kp_valid[kf]
    jmk = jm.match_nn(jh.unpack_pm1(jstate.kf_desc[kf]), jf.desc_pm1, jhas_kf[:, None] & jf.kp_valid[None, :],
                      max_dist=jm.TH_LOW, nn_ratio=0.75)
    jmk = jm.resolve_duplicates(jmk.idx, jmk.dist, jmk.ok, N)
    jfm = jnp.full(N, -1, jnp.int32).at[jnp.where(jmk.ok, jmk.idx, N)].set(jnp.where(jmk.ok, jstate.kf_mp[kf], -1),
                                                                            mode="drop")
    q = torch.nonzero(m.ok).flatten()
    d = (frame.xy[m.idx[q].long()] - state.kf_xy[kf][q]).numpy()
    consistent = np.linalg.norm(d - np.median(d, 0), axis=1) < 8.0
    print(f"frame {f} against keyframe {kf} ({int(kf_has.sum())} map points): {int(has.sum())} correspondences "
          f"(the reference's equal: {bool(np.array_equal(np.asarray(jfm), frame_mp.numpy()))}), "
          f"{int(consistent.sum())} within 8 px of their median displacement {np.median(d, 0)}")
    sets = reference_sets(fid, kf, has)
    res = pnp.pnp_ransac(pw, frame.xy, inv_s2, has, tslam._K, sets=sets)
    jres = jpnp.pnp_ransac(jnp.asarray(pw.numpy()), jf.xy, jtr.INV_LEVEL_SIGMA2[jnp.clip(jf.level, 0, 7)],
                           jnp.asarray(has.numpy()), jslam._K, jax.random.key(fid * 97 + kf))
    print(f"RANSAC with the reference's key: port {int(res.n_inliers)} inliers, reference {int(jres.n_inliers)}")
    fr = m.idx[q[torch.as_tensor(consistent)]].long()
    g = torch.Generator().manual_seed(0)
    good = 0
    for _ in range(50):
        s = fr[torch.randperm(len(fr), generator=g)[:6]]
        T = pnp._dlt_pose(pw[s][None], frame.xy[s][None], tslam._K)
        good += int(pnp.hypothesis_inliers(T, pw, frame.xy, inv_s2, has, tslam._K)[0].sum()) >= 20
    sv = np.linalg.svd(pw[has].double().numpy() - pw[has].double().numpy().mean(0), compute_uv=False)
    print(f"six-point DLT hypotheses from consistent correspondences scoring >= 20 inliers: {good}/50; "
          f"the points' spread along their principal axes {sv / np.sqrt(int(has.sum()))} m")


def jslam_frame(jslam, img, dep, fid, cfg):
    from orb_slam2v2_1_tpu.models import frontend as jfe

    return jfe.build_frame_only(jnp.asarray(img.numpy()), jnp.asarray(dep.numpy()), jslam._K, jslam._dist, jslam._bf,
                                jnp.int32(fid), jslam._orb_cfg, True, cfg.width, cfg.height)


if __name__ == "__main__":
    main()
