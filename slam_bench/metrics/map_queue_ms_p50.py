"""Median time a keyframe waited in the mapping queue, from its submit to
the start of its mapping round (the system's "map_queue" span), over the
rounds that started in the window."""

import numpy as np


def read(run):
    samples = run.stage_ms.get("map_queue")
    return float(np.percentile(samples, 50)) if samples else None
