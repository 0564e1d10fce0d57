"""Median latency, submitting call to published pose, over every frame
published in the window."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 50)) * 1e3 if run.latencies_s else None
