"""Map persistence: save and load the whole map state as array snapshots.

Port of the JAX package's `utils/serialization.py`, in its file format: one
compressed npz with `map_<field>` arrays in the reference's numpy layout
(uint32 descriptors, see `map_state.to_numpy`), `meta_<key>` entries and a
`format_version`. A file either package writes loads in the other. On load
the BoW database is rebuilt by quantizing the keyframes' descriptors again
(the reference's BoW recomputation on load, src/System.cc:867-875).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import sync
from ..models import keyframe_database as kdb
from ..models import map_state
from ..models.map_state import MapState

FORMAT_VERSION = 1


def save_map(state: MapState, path: str | Path, metadata: dict | None = None):
    arrays = {f"map_{k}": v for k, v in map_state.to_numpy(state).items()}
    arrays["format_version"] = np.int32(FORMAT_VERSION)
    for k, v in (metadata or {}).items():
        arrays[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_map(path: str | Path, device=None) -> tuple[MapState, dict]:
    """(state on `device` (None: the card), metadata). Raises ValueError on
    another format version. Fields an older snapshot lacks take a fresh
    map's values; its insertion order is then the slot order (old snapshots
    never culled) and the covisibility is derived again."""
    data = np.load(path)
    version = int(data["format_version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported map format {version}")
    missing = [n for n in MapState._fields if f"map_{n}" not in data.files]
    arrays = {n: data[f"map_{n}"] for n in MapState._fields if n not in missing}
    if missing:
        defaults = map_state.to_numpy(map_state.empty_map(
            data["map_kf_valid"].shape[0], data["map_mp_valid"].shape[0], data["map_kf_mp"].shape[1], device="cpu"))
        arrays.update({n: defaults[n] for n in missing})
    meta = {k[len("meta_"):]: data[k] for k in data.files if k.startswith("meta_")}
    state = map_state.from_numpy(arrays, device=device)
    if missing:
        if "kf_seq" in missing:
            slots = torch.arange(state.max_kf, dtype=torch.int32, device=state.kf_valid.device)
            state = state._replace(kf_seq=torch.where(state.kf_valid, slots, -1), n_seq=state.n_kf.clone())
        state = map_state.refresh_covis(state)
    return state, meta


def rebuild_database(state: MapState, voc, max_kf: int, n_kp: int) -> kdb.BowDatabase:
    """Quantize every live keyframe into a fresh BoW database (the load-time
    BoW recomputation, src/System.cc:867-875)."""
    db = kdb.empty_database(max_kf, n_kp, voc.n_words, device=state.kf_pose.device)
    n_kf, valid = sync.host_numpy(state.n_kf, state.kf_valid)
    for k in range(int(n_kf)):
        if valid[k]:
            db = kdb.add_keyframe(db, voc, k, state.kf_desc[k], state.kf_kp_valid[k])
    return db
