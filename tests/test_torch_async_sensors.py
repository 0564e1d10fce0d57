"""`SlamSystem(async_mapping=True)` for stereo and mono, on both packages
(CPU), under the settled schedule of `torch_async_helpers.py`.

- Stereo: the 12 dolly steps of `test_torch_system.py` (320x240, bf=22,
  th_depth=100).
- Mono: 18 frames of the lateral sweep at 320x240 (fx=400, 1000 features:
  at fx=275 neither package initializes on the desk), the port drawing the
  reference's two-view RANSAC sets (its sampler) for each frame's key, as
  `test_torch_mono.py` does.
The same `None` pattern, poses within 2 mm / 0.05 deg, equal keyframe counts
and `stats()` counters.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_async_helpers import assert_runs_agree, pair, run_settled

from orb_slam2v2_1_tpu.ops import twoview as jtv

from orb_slam2v2_1_tpu_torch.ops import twoview
from orb_slam2v2_1_tpu_torch.utils import config, synthetic

torch.set_num_threads(2)

BASE = dict(fx=275.0, fy=275.0, cx=160.0, cy=120.0, width=320, height=240, n_features=700,
            max_keyframes=16, max_map_points=4096, fps=10.0, bf=44.0, th_depth=100.0)
STEREO_KW = dict(BASE, bf=22.0)
MONO_KW = dict(BASE, fx=400.0, fy=400.0, n_features=1000, bf=0.0, th_depth=40.0)
N_STEREO, N_MONO = 12, 18


@pytest.fixture(scope="module")
def stereo_runs():
    left, right, _ = synthetic.stereo_dolly_frames(config.SlamConfig(**STEREO_KW), range(N_STEREO),
                                                   np.random.default_rng(3), device="cpu")
    frames = list(zip(left.numpy(), right.numpy()))
    jslam, tslam = pair("STEREO", STEREO_KW)
    try:
        yield jslam, tslam, run_settled(jslam, frames, jslam.track_stereo), run_settled(tslam, frames,
                                                                                          tslam.track_stereo)
    finally:
        jslam.shutdown()
        tslam.shutdown()


def test_stereo_async_parity(stereo_runs):
    jslam, tslam, jout, tout = stereo_runs
    assert all(o is not None for o in jout)
    assert_runs_agree(jslam, tslam, jout, tout)


@pytest.fixture(scope="module")
def mono_runs():
    imgs, _, _ = synthetic.desk_frames(config.SlamConfig(**MONO_KW), synthetic.lateral_trajectory(100)[:N_MONO],
                                       device="cpu")
    frames = [(img, None) for img in imgs.numpy()]
    jslam, tslam = pair("MONOCULAR", MONO_KW)
    real = twoview.sample_sets

    def reference_draw(valid, key, k=8):
        # The reference's own sampler on the same key (a half of the split
        # of jax.random.key(frame id)).
        jkey = jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32))
        return torch.from_numpy(np.array(jtv._sample_sets(jkey, jnp.asarray(valid.numpy()), jtv.N_RANSAC, k)))

    try:
        jout = run_settled(jslam, frames, lambda a, b, ts: jslam.track_monocular(a, ts))
        twoview.sample_sets = reference_draw
        tout = run_settled(tslam, frames, lambda a, b, ts: tslam.track_monocular(a, ts))
        yield jslam, tslam, jout, tout
    finally:
        twoview.sample_sets = real
        jslam.shutdown()
        tslam.shutdown()


def test_mono_async_parity(mono_runs):
    jslam, tslam, jout, tout = mono_runs
    pattern = [o is not None for o in jout]
    first = pattern.index(True)
    assert 0 < first < N_MONO - 4 and all(pattern[first:])
    assert_runs_agree(jslam, tslam, jout, tout, min_kf=3)
