"""Binary bag-of-words vocabulary: training, quantization, scoring.

Port of the JAX package's `ops/vocab.py`: a k-ary tree (k=10, L=4, 10000
words) of binary centroids trained by k-medians, descended per descriptor at
run time, and dense tf-idf BoW vectors scored by L1 similarity.

The reference descends the tree with +-1 dot products; the port holds the
centroids as packed int32 words (the layout of every descriptor in the port,
see `ops/hamming.py`) and descends with XOR + popcount. Both are exact, and
the largest dot is the smallest Hamming distance with the same first-index
tie rule, so the word and node ids are the reference's. Descriptors are
therefore passed as (..., N, 8) int32 words, not as +-1 vectors.

The host part (training, DBoW2 text import and export) is numpy.
`vocabulary_from_numpy` / `vocabulary_to_numpy` carry a vocabulary across
from and to the reference's layout (+-1 centroids per level).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from . import hamming

K_BRANCH = 10
LEVELS = 4  # 10^4 = 10000 words


class Vocabulary(NamedTuple):
    # Flattened tree: level l has K_BRANCH^(l+1) nodes.
    nodes: tuple  # per level: (K^(l+1), 8) int32 centroid words
    word_weight: torch.Tensor  # (W,) f32 idf weights
    # Per-level node validity for imported (incomplete) DBoW2 trees; empty
    # tuple = complete tree (all nodes valid).
    node_valid: tuple = ()

    @property
    def n_words(self) -> int:
        return self.nodes[-1].shape[0]


def _pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """(n, 256) {0,1} -> (n, 8) int32 words, bit b of word w = bit 32w+b."""
    packed = np.packbits(np.asarray(bits, np.uint8), axis=1, bitorder="little")
    return hamming.words_from_uint32(np.ascontiguousarray(packed).view(np.uint32))


def _from_bits(level_bits, word_weight, level_valid, device) -> Vocabulary:
    return Vocabulary(
        nodes=tuple(torch.from_numpy(_pack_bits_np(b)).to(device) for b in level_bits),
        word_weight=torch.from_numpy(np.asarray(word_weight, np.float32)).to(device),
        node_valid=tuple(torch.from_numpy(np.asarray(v, bool)).to(device) for v in level_valid),
    )


def load_vocabulary(npz, device=None) -> Vocabulary:
    """Load arrays (from np.load or a dict: `level0`..`level3` centroid bits
    and `word_weight`) onto `device` (None: the card)."""
    device = device_mod.resolve(device)
    return _from_bits([np.asarray(npz[f"level{lvl}"], np.uint8) for lvl in range(LEVELS)],
                      npz["word_weight"], (), device)


def vocabulary_from_numpy(nodes_pm1, word_weight, node_valid=(), device=None) -> Vocabulary:
    """Vocabulary on `device` (None: the card) from the reference's arrays:
    per-level (K^(l+1), 256) +-1 centroids, idf weights and validity."""
    device = device_mod.resolve(device)
    bits = [(np.asarray(n, np.float32) > 0).astype(np.uint8) for n in nodes_pm1]
    return _from_bits(bits, word_weight, node_valid, device)


def vocabulary_to_numpy(voc: Vocabulary) -> dict:
    """The reference's layout of `voc`: float32 +-1 centroids per level."""
    return {
        "nodes_pm1": [hamming.unpack_pm1(n).cpu().numpy() for n in voc.nodes],
        "word_weight": voc.word_weight.cpu().numpy(),
        "node_valid": [v.cpu().numpy() for v in voc.node_valid],
    }


# ---------------------------------------------------------------------------
# Training and DBoW2 interop (host, numpy)
# ---------------------------------------------------------------------------

def _kmedians_binary(bits: np.ndarray, k: int, rng, iters: int = 8) -> np.ndarray:
    """Binary k-medians: majority-vote centroids, Hamming assignment.

    bits: (N, 256) uint8 in {0,1}. Returns (k, 256) centroids.
    """
    n = bits.shape[0]
    if n <= k:
        out = np.zeros((k, 256), np.uint8)
        out[:n] = bits
        return out
    centers = bits[rng.choice(n, k, replace=False)].copy()
    for _ in range(iters):
        # Hamming distances via dot on +-1.
        pm_b = bits.astype(np.int32) * 2 - 1
        pm_c = centers.astype(np.int32) * 2 - 1
        d = 256 - pm_b @ pm_c.T  # monotone in Hamming
        assign = d.argmin(1)
        for j in range(k):
            sel = bits[assign == j]
            if len(sel):
                centers[j] = (sel.mean(0) > 0.5).astype(np.uint8)
            else:
                centers[j] = bits[rng.integers(n)]
    return centers


def train_vocabulary(descriptors: np.ndarray, rng=None) -> dict:
    """Train the k-ary tree from packed descriptors (N, 8) uint32.

    Returns plain numpy arrays (save with np.savez). Mirrors
    `TemplatedVocabulary::create` (HKmeansStep recursion) with k=10, L=4.
    """
    rng = rng or np.random.default_rng(0)
    bits = np.unpackbits(
        descriptors.view(np.uint8), axis=1, bitorder="little"
    ).astype(np.uint8)  # (N,256)

    levels = []
    groups = [np.arange(len(bits))]
    for lvl in range(LEVELS):
        centers_all = []
        next_groups = []
        for g in groups:
            centers = _kmedians_binary(bits[g], K_BRANCH, rng)
            centers_all.append(centers)
            if lvl < LEVELS - 1:
                pm_b = bits[g].astype(np.int32) * 2 - 1
                pm_c = centers.astype(np.int32) * 2 - 1
                assign = (256 - pm_b @ pm_c.T).argmin(1)
                for j in range(K_BRANCH):
                    next_groups.append(g[assign == j])
        levels.append(np.concatenate(centers_all))  # (K^(l+1), 256)
        groups = next_groups

    # idf weights from the training corpus word histogram.
    words = _assign_words_np(bits, levels)
    counts = np.bincount(words, minlength=K_BRANCH**LEVELS).astype(np.float64)
    n_docs = max(len(bits), 1)
    idf = np.log(n_docs / np.maximum(counts, 1.0)).astype(np.float32)
    return {
        **{f"level{l}": levels[l] for l in range(LEVELS)},
        "word_weight": idf,
    }


def _assign_words_np(bits: np.ndarray, levels: list[np.ndarray]) -> np.ndarray:
    node = np.zeros(len(bits), np.int64)
    pm_b = bits.astype(np.int32) * 2 - 1
    for lvl in range(LEVELS):
        base = node * K_BRANCH
        cand = levels[lvl][(base[:, None] + np.arange(K_BRANCH)[None, :]) % len(levels[lvl])]
        pm_c = cand.astype(np.int32) * 2 - 1
        d = 256 - np.einsum("nb,nkb->nk", pm_b, pm_c)
        node = base + d.argmin(1)
    return node


# ---------------------------------------------------------------------------
# DBoW2 text-format interop (TemplatedVocabulary::loadFromTextFile /
# saveToTextFile, TemplatedVocabulary.h:1351-1464): header "k L scoring
# weighting", then one node per line in insertion order:
# "parent isLeaf d0 .. d31 weight".
# ---------------------------------------------------------------------------

def import_dbow2_text(path, levels: int = LEVELS, device=None) -> Vocabulary:
    """Load a DBoW2 ORB text vocabulary (e.g. the stock ORBvoc.txt) into the
    flattened-tree runtime form.

    Trees deeper than `levels` are truncated: depth-`levels` nodes become
    words, with weight = sum of descendant leaf weights (tf-idf mass is
    preserved). Incomplete branches are masked via Vocabulary.node_valid so
    tree descent never routes into a hole.
    """
    with open(path) as f:
        header = f.readline().split()
        k = int(header[0])
        if k != K_BRANCH:
            raise ValueError(f"only k={K_BRANCH} vocabularies supported, got k={k}")
        parents, is_leaf, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            is_leaf.append(int(parts[1]) > 0)
            descs.append(np.array(parts[2:34], np.uint8))
            weights.append(float(parts[34]))
    n = len(parents)
    parents = np.asarray(parents)
    # Node ids in the file are 1-based (root = 0, implicit); compute depth and
    # per-parent child rank in insertion order (the parser at
    # TemplatedVocabulary.h:1397-1404 appends children in file order).
    depth = np.zeros(n + 1, np.int32)  # [0] = root
    rank = np.zeros(n, np.int32)
    child_count = np.zeros(n + 1, np.int32)
    for i in range(n):
        p = parents[i]
        depth[i + 1] = depth[p] + 1
        rank[i] = child_count[p]
        child_count[p] += 1

    # Flat slot of each node in the complete K^depth layout.
    slot = np.zeros(n + 1, np.int64)
    for i in range(n):
        slot[i + 1] = slot[parents[i]] * K_BRANCH + rank[i]

    bits_all = np.unpackbits(
        np.stack(descs) if descs else np.zeros((0, 32), np.uint8),
        axis=1, bitorder="little",
    )
    level_bits = []
    level_valid = []
    for lvl in range(levels):
        size = K_BRANCH ** (lvl + 1)
        lb = np.zeros((size, 256), np.uint8)
        lv = np.zeros(size, bool)
        sel = np.nonzero(depth[1:] == lvl + 1)[0]
        lb[slot[sel + 1]] = bits_all[sel]
        lv[slot[sel + 1]] = True
        level_bits.append(lb)
        level_valid.append(lv)

    # Word weights at the truncation depth: accumulate every original leaf's
    # weight into its depth-`levels` ancestor slot.
    w = np.zeros(K_BRANCH ** levels, np.float64)
    anc = np.zeros(n + 1, np.int64)  # ancestor slot at `levels`, tracked lazily
    for i in range(n):
        d = depth[i + 1]
        if d == levels:
            anc[i + 1] = slot[i + 1]
        elif d > levels:
            anc[i + 1] = anc[parents[i]]
        if is_leaf[i] and d >= levels:
            w[anc[i + 1]] += weights[i]
        elif is_leaf[i] and d < levels:
            # Shallow leaf: its subtree is a single chain of copies; weight
            # lands on its slot scaled up to the truncation depth.
            s = slot[i + 1]
            for _ in range(levels - d):
                s = s * K_BRANCH
            w[s] += weights[i]
            # Make the descent able to reach it: replicate the centroid down.
            for l2 in range(d, levels):
                s2 = slot[i + 1]
                for _ in range(l2 + 1 - d):
                    s2 = s2 * K_BRANCH
                level_bits[l2][s2] = bits_all[i]
                level_valid[l2][s2] = True

    return _from_bits(level_bits, w, level_valid, device_mod.resolve(device))


def export_dbow2_text(vocab_npz: dict, path, scoring: int = 0, weighting: int = 0):
    """Write our trained complete tree in DBoW2 text format (saveToTextFile
    layout) so reference-tooling users can consume it."""
    levels = [np.asarray(vocab_npz[f"level{l}"], np.uint8) for l in range(LEVELS)]
    weight = np.asarray(vocab_npz["word_weight"], np.float64)
    with open(path, "w") as f:
        f.write(f"{K_BRANCH} {LEVELS}  {scoring} {weighting}\n")
        # Complete tree, breadth-first: file node id of (lvl, slot) =
        # 1 + sum_{l<lvl} K^(l+1) + slot; root is implicit id 0.
        offset = [0]
        for l in range(LEVELS):
            offset.append(offset[-1] + K_BRANCH ** (l + 1))
        for lvl in range(LEVELS):
            bits = levels[lvl]
            for s in range(bits.shape[0]):
                parent = 0 if lvl == 0 else offset[lvl - 1] + s // K_BRANCH + 1
                leaf = 1 if lvl == LEVELS - 1 else 0
                byts = np.packbits(bits[s], bitorder="little")
                w = weight[s] if leaf else 0.0
                f.write(
                    f"{parent} {leaf} " + " ".join(str(int(b)) for b in byts)
                    + f" {w}\n"
                )


# ---------------------------------------------------------------------------
# Runtime quantization + BoW (device)
# ---------------------------------------------------------------------------

_FAR = 1 << 20


def assign_nodes(voc: Vocabulary, desc: torch.Tensor, depth: int = 2) -> torch.Tensor:
    """Truncated tree descent: (..., N, 8) descriptor words -> (..., N) int64
    ids of their level-`depth` ancestor node (the FeatureVector alignment
    node: searches match only features sharing it). Each level gathers the
    current node's K children and takes the Hamming-nearest, the first on
    ties; holes of an imported tree are never entered."""
    node = torch.zeros(desc.shape[:-1], dtype=torch.int64, device=desc.device)
    k = torch.arange(K_BRANCH, device=desc.device)
    for lvl in range(depth):
        base = node * K_BRANCH
        cand_idx = base[..., None] + k
        d = hamming.distance_packed(desc[..., None, :], voc.nodes[lvl][cand_idx])
        if voc.node_valid:
            d = torch.where(voc.node_valid[lvl][cand_idx], d, _FAR)
        node = base + torch.argmin(d, dim=-1)
    return node


def assign_words(voc: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    """Full tree descent: (..., N, 8) descriptor words -> (..., N) int64 word
    ids."""
    return assign_nodes(voc, desc, depth=LEVELS)


def bow_vector(words: torch.Tensor, valid: torch.Tensor, word_weight: torch.Tensor,
               n_words: int) -> torch.Tensor:
    """tf-idf L1-normalized dense BoW vector: (..., N) words -> (..., W) f32."""
    hist = torch.zeros(words.shape[:-1] + (n_words + 1,), dtype=torch.float32, device=words.device)
    idx = torch.where(valid, words, n_words)
    hist = hist.scatter_add(-1, idx, torch.ones_like(idx, dtype=torch.float32))[..., :n_words]
    v = hist * word_weight
    return v / torch.clamp(torch.sum(v, dim=-1, keepdim=True), min=1e-9)


def bow_scores(query: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """L1 similarity between queries (..., W) and database rows (K, W):
    s = 1 - 0.5*||q - d||_1 (DBoW2 L1Scoring), computed densely -> (..., K)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(query[..., None, :] - database), dim=-1)
