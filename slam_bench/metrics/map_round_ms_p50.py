"""Median wall of the local-mapping rounds (the system's "map" stage
samples) that ended in the window."""

import numpy as np


def read(run):
    samples = run.stage_ms["map"]
    return float(np.percentile(samples, 50)) if samples else None
