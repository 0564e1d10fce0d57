"""Keyframe recognition database: dense BoW store + batched scoring.

Port of the JAX package's `models/keyframe_database.py`: keyframe BoW
vectors live in one dense (K, W) matrix and a query is one L1 score against
all keyframes at once. The candidate logic keeps the reference's semantics:
exclude covisible keyframes, require a minimum score relative to the query's
covisible neighbourhood, and accumulate covisibility-group scores
(DetectLoopCandidates); no minimum score for relocalization.

Every update is out of place: the database is written by the loop stage and
may be read by another thread (relocalization candidates), so a reader's
tensors are never overwritten. `database_from_numpy` / `database_to_numpy`
carry a database across from and to the reference's arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..ops import vocab
from ..ops.topk import set_drop
from .map_state import MapState


class BowDatabase(NamedTuple):
    vectors: torch.Tensor  # (K, W) f32 L1-normalized tf-idf
    words: torch.Tensor  # (K, N) i32 per-keypoint word ids
    valid: torch.Tensor  # (K,) bool


def empty_database(max_kf: int, n_kp: int, n_words: int, device=None) -> BowDatabase:
    """An empty database on `device` (None: the card, see `device.resolve`)."""
    device = device_mod.resolve(device)
    return BowDatabase(
        vectors=torch.zeros((max_kf, n_words), dtype=torch.float32, device=device),
        words=torch.zeros((max_kf, n_kp), dtype=torch.int32, device=device),
        valid=torch.zeros(max_kf, dtype=torch.bool, device=device),
    )


def database_from_numpy(arrays: dict, device=None) -> BowDatabase:
    """BowDatabase on `device` (None: the card) from the reference's arrays."""
    device = device_mod.resolve(device)
    return BowDatabase(**{
        name: torch.from_numpy(np.array(arrays[name])).to(device) for name in BowDatabase._fields
    })


def database_to_numpy(db: BowDatabase) -> dict:
    return {name: t.detach().cpu().numpy() for name, t in zip(BowDatabase._fields, db)}


def _bow_rows(db: BowDatabase, voc: vocab.Vocabulary, desc, kp_valid):
    words = vocab.assign_words(voc, desc)
    return words, vocab.bow_vector(words, kp_valid, voc.word_weight, db.vectors.shape[1])


def add_keyframe(db: BowDatabase, voc: vocab.Vocabulary, kf_id, desc, kp_valid) -> BowDatabase:
    """Quantize a keyframe's descriptor words (N, 8) and store its BoW vector
    (KeyFrameDatabase::add)."""
    words, vec = _bow_rows(db, voc, desc, kp_valid)
    tgt = torch.as_tensor(kf_id, device=desc.device).reshape(1).long()
    return BowDatabase(
        vectors=set_drop(db.vectors, tgt, vec[None]),
        words=set_drop(db.words, tgt, words[None]),
        valid=set_drop(db.valid, tgt, True),
    )


def add_and_detect_batch(db: BowDatabase, voc: vocab.Vocabulary, state: MapState, slots):
    """Add + detect for a batch of keyframes (slots (S,) padded with -1): all
    registrations land with one scatter, then detection runs for all. Unlike
    the reference's strictly sequential order, keyframe i's detection can
    see same-batch keyframes j > i; harmless, because same-chunk keyframes
    are covisible neighbours and the candidate mask excludes the query's
    covisible group. Returns (db, scores (S, K), cand (S, K))."""
    ok = slots >= 0
    sl = torch.clamp(slots, min=0).long()
    words, vecs = _bow_rows(db, voc, state.kf_desc[sl], state.kf_kp_valid[sl])
    tgt = torch.where(ok, sl, db.vectors.shape[0])  # pads go to the sentinel row
    db = BowDatabase(
        vectors=set_drop(db.vectors, tgt, vecs),
        words=set_drop(db.words, tgt, words),
        valid=set_drop(db.valid, tgt, True),
    )
    scores, cand, _ = detect_loop_candidates(db, state, sl)
    return db, scores, cand & ok[:, None]


def add_keyframe_from_state(db: BowDatabase, voc: vocab.Vocabulary, state: MapState, kf_id) -> BowDatabase:
    """Registration only, from the keyframe's row of the map."""
    return add_keyframe(db, voc, kf_id, state.kf_desc[kf_id], state.kf_kp_valid[kf_id])


def add_and_detect(db: BowDatabase, voc: vocab.Vocabulary, state: MapState, kf_id):
    """KeyFrameDatabase::add + DetectLoopCandidates for one keyframe.
    Returns (db, scores (K,), cand (K,))."""
    db = add_keyframe_from_state(db, voc, state, kf_id)
    scores, cand, _ = detect_loop_candidates(db, state, kf_id)
    return db, scores, cand


def _masked_scores(db: BowDatabase, state: MapState, q: torch.Tensor) -> torch.Tensor:
    scores = vocab.bow_scores(q, db.vectors)
    return torch.where(db.valid & state.kf_valid, scores, -1.0)


def detect_loop_candidates(db: BowDatabase, state: MapState, query_kf):
    """Loop candidates for keyframe(s) `query_kf` (() or (S,) ids)
    (DetectLoopCandidates). Returns (scores (.., K), candidate_mask (.., K),
    min_score (..)): candidates exclude the query's covisible neighbourhood
    and must beat min_score, the lowest BoW similarity to a covisible
    neighbour; of those, the ones whose covisibility-group score reaches
    0.75 of the best are kept."""
    query_kf = torch.as_tensor(query_kf, device=db.vectors.device).long()
    C = state.covis
    covis = C[query_kf] > 0
    scores = _masked_scores(db, state, db.vectors[query_kf])

    inf = torch.full_like(scores, float("inf"))
    min_score = torch.clamp(torch.amin(torch.where(covis, scores, inf), dim=-1), max=1.0)
    min_score = torch.where(torch.isinf(min_score), 0.0, min_score)

    iota = torch.arange(scores.shape[-1], device=scores.device)
    self_or_covis = covis | (iota == query_kf[..., None])
    cand = ~self_or_covis & (scores >= torch.clamp(min_score, min=1e-6)[..., None])

    neigh_best = torch.amax(torch.where(C > 0, scores[..., None, :], 0.0), dim=-1)
    acc = torch.where(cand, scores + neigh_best, -1.0)
    best_acc = torch.amax(acc, dim=-1, keepdim=True)
    cand = cand & (acc >= 0.75 * best_acc) & (best_acc > 0)
    return scores, cand, min_score


def detect_reloc_candidates(db: BowDatabase, state: MapState, frame_words, frame_kp_valid, word_weight):
    """Relocalization candidates for a lost frame
    (DetectRelocalizationCandidates). Returns (scores (K,), cand (K,))."""
    q = vocab.bow_vector(frame_words.long(), frame_kp_valid, word_weight, db.vectors.shape[1])
    scores = _masked_scores(db, state, q)
    best = torch.amax(scores)
    cand = scores >= 0.75 * torch.clamp(best, min=1e-9)
    return scores, cand & (best > 0)
