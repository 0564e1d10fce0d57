"""Median length of the local bundle adjustments of the mapping rounds that
ran one (the system's "local_ba" span) in the window."""

import numpy as np


def read(run):
    samples = run.stage_ms.get("local_ba")
    return float(np.percentile(samples, 50)) if samples else None
