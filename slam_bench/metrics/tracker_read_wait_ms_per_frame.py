"""Mean ms a `track_*` call of the window spent blocked in counted
device-to-host reads (the system's "track_read_wait" counter, one sample a
call)."""

import numpy as np


def read(run):
    samples = run.stage_ms.get("track_read_wait")
    return float(np.mean(samples)) if samples else None
