"""Mean ms a `track_*` call of the window spent blocked on the mapping
worker: on the map's structural lock, or pushing to a full mapping queue
(the system's "track_map_wait" counter, one sample a call)."""

import numpy as np


def read(run):
    samples = run.stage_ms.get("track_map_wait")
    return float(np.mean(samples)) if samples else None
