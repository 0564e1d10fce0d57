"""Median length of the tracker's frame builds (the system's "frame_build"
span: the ORB pyramid, its two kernels and the depth sampling of a frame)
that ended in the window."""

import numpy as np


def read(run):
    samples = run.stage_ms.get("frame_build")
    return float(np.percentile(samples, 50)) if samples else None
