"""A lateral sweep: the camera faces +z and swings along x about `center`,
`amplitude_m` to each side, once every `period` frames, so that every
frame sees parallax (what a monocular initializer needs). A camera path as
a later cell adds it: `paths/<kind>.py` of the harness, numpy only."""

import numpy as np


def poses(frames, center, amplitude_m, period):
    """True Tcw (n, 4, 4) of the given frame numbers."""
    out = np.tile(np.eye(4), (len(frames), 1, 1))
    k = np.asarray(frames, np.float64)
    c = np.asarray(center, np.float64) + np.outer(amplitude_m * np.sin(2.0 * np.pi * k / period), [1.0, 0.0, 0.0])
    out[:, :3, 3] = -c
    return out
