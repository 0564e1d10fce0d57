"""Relocalization after tracking loss.

Port of the JAX package's `models/relocalization.py` (`Tracking::Relocalization`,
src/Tracking.cc:1486-1648): BoW candidate retrieval, descriptor matching
against each candidate keyframe (ratio 0.75), batched DLT-RANSAC pose,
motion-only optimization, a guided projection search (kernel 2, match form)
and a second optimization, accepted at >= 50 inliers.

The candidate loop stays on the host, as in the reference: one read for the
candidates' scores, then one per candidate tried (at most 5). Each candidate's
RANSAC draws from the reference's own key, `frame_id * 97 + kf`, through
`ops/prng.py`, so it picks the reference's hypothesis sets on every device; a
caller can pass the hypothesis sets instead (`sets`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import sync
from ..ops import ba, hamming, matching, pnp, prng
from ..ops import vocab as vocab_ops
from ..ops.projection import project
from . import keyframe_database as kdb
from .map_state import MapState, _mark
from .tracking import N_LEVELS, FrameData, _associate, _level_pow, inv_level_sigma2, make_obs_from_frame

MIN_INLIERS = 50
MAX_CANDIDATES = 5


def _match_and_pnp(state: MapState, frame: FrameData, kf: int, K, bf, key: prng.Key | None = None,
                   sets=None):
    """Match the frame against candidate keyframe `kf`'s map points, run PnP
    RANSAC, optimize, widen by a guided projection search and optimize again.
    `sets`, if given, is a function of the correspondences' validity mask
    that returns the (N_HYP, 6) hypothesis sets in place of the key's draw.
    Returns (ransac success, Tcw, frame_mp, n_inliers)."""
    N = frame.xy.shape[0]
    M = state.max_mp
    kf_mp = state.kf_mp[kf]
    kf_has = (kf_mp >= 0) & state.kf_kp_valid[kf]
    mask = kf_has[:, None] & frame.kp_valid[None, :]
    m = matching.match_nn(hamming.unpack_pm1(state.kf_desc[kf]), frame.desc_pm1, mask,
                          max_dist=matching.TH_LOW, nn_ratio=0.75)
    m = matching.resolve_duplicates(m.idx, m.dist, m.ok, N)

    # 2D-3D correspondences on frame slots.
    frame_mp = _associate(N, m.ok, m.idx, kf_mp)
    has = frame_mp >= 0
    pw = state.mp_pos[torch.clamp(frame_mp, min=0).long()]
    inv_s2 = inv_level_sigma2(frame.xy.device)[torch.clamp(frame.level, 0, N_LEVELS - 1).long()]
    res = pnp.pnp_ransac(pw, frame.xy, inv_s2, has, K, key=key, sets=None if sets is None else sets(has))

    obs = make_obs_from_frame(frame.xy, frame.ur, frame.level, frame_mp, frame.kp_valid & res.inliers)
    Tcw, inlier_mask, n_inl = ba.pose_optimization(res.Tcw, state.mp_pos, obs, K, bf)
    frame_mp = torch.where(inlier_mask | (frame_mp < 0), frame_mp, -1)

    # Guided widening (src/Tracking.cc:1586-1633): project all of the
    # candidate's points with the coarse pose (radius 10 x octave scale) to
    # recover matches the ratio test missed, then re-optimize. The reference
    # runs it when the first pass lands in (10, 50) inliers; running it
    # always and keeping the better result is the same.
    kc = torch.clamp(kf_mp, min=0).long()
    q_ok = kf_has & state.mp_valid[kc]
    pw_kf = state.mp_pos[kc]
    uv = project(Tcw, pw_kf, K)
    z = (Tcw[2, :3] @ pw_kf.T) + Tcw[2, 3]
    already = _mark(M + 1, torch.where(frame_mp >= 0, frame_mp, M), frame.xy.device)
    kf_level = state.kf_level[kf]
    mm = matching.match_projection(
        state.kf_desc[kf], uv, kf_level, q_ok & (z > 0) & ~already[kc],
        frame.desc, frame.xy, frame.level, frame.kp_valid & (frame_mp < 0),
        10.0 * _level_pow(torch.clamp(kf_level, 0, N_LEVELS - 1)),
        max_dist=matching.TH_HIGH, nn_ratio=1.0,
    )
    frame_mp2 = _associate(N, mm.ok, mm.idx, kf_mp, base=frame_mp)
    obs2 = make_obs_from_frame(frame.xy, frame.ur, frame.level, frame_mp2, frame.kp_valid)
    Tcw2, inlier2, n_inl2 = ba.pose_optimization(Tcw, state.mp_pos, obs2, K, bf)
    frame_mp2 = torch.where(inlier2 | (frame_mp2 < 0), frame_mp2, -1)
    better = n_inl2 >= n_inl
    return (res.success, torch.where(better, Tcw2, Tcw), torch.where(better, frame_mp2, frame_mp),
            torch.maximum(n_inl2, n_inl))


def relocalize(state: MapState, db: kdb.BowDatabase, voc: vocab_ops.Vocabulary, frame: FrameData, K, bf,
               frame_id: int, sets=None):
    """The strongest BoW candidates, at most 5, tried in order; the first
    with >= 50 inliers after refinement is accepted (src/Tracking.cc:1637-1644).
    `sets(kf, valid)` may give each candidate's hypothesis sets in place of
    its key's draw. Returns (ok, Tcw, frame_mp, ref_kf)."""
    words = vocab_ops.assign_words(voc, frame.desc)
    scores, cand = kdb.detect_reloc_candidates(db, state, words, frame.kp_valid, voc.word_weight)
    sc, cd = sync.host_numpy(scores, cand)
    cand_ids = np.where(cd)[0]
    if len(cand_ids) == 0:
        return False, None, None, None
    for kf in cand_ids[np.argsort(-sc[cand_ids])][:MAX_CANDIDATES]:
        kf = int(kf)
        kf_sets = None if sets is None else (lambda valid, kf=kf: sets(kf, valid))
        _, Tcw, frame_mp, n_inl = _match_and_pnp(state, frame, kf, K, bf, prng.key(frame_id * 97 + kf), kf_sets)
        # Accept on the refined inlier count alone (the reference's nGood >=
        # 50): 50 observations inside the chi2 gate after 4 rounds of
        # re-classification are the pose verification.
        if sync.host(n_inl) >= MIN_INLIERS:
            return True, Tcw, frame_mp, kf
    return False, None, None, None
