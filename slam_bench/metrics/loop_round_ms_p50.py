"""Median wall of the loop-detection rounds (the system's "loop" stage
samples) that ended in the window."""

import numpy as np


def read(run):
    samples = run.stage_ms["loop"]
    return float(np.percentile(samples, 50)) if samples else None
