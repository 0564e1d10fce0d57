"""Median length of the tracker's tracking stage (the system's "tracking"
span: the motion-model or reference-keyframe search with its reads, the
local-map search and the keyframe statistics) in the window."""

import numpy as np


def read(run):
    samples = run.stage_ms.get("tracking")
    return float(np.percentile(samples, 50)) if samples else None
