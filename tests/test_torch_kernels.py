"""The hand-written CUDA kernels' wrappers and their device dispatch.

On the CPU (this suite's default) the dispatching functions
`ops.fast.suppressed_score` and `ops.matching.masked_best_two` run the plain
PyTorch versions and never reach `kernels`; the wrappers in `kernels` accept
CUDA tensors only. The kernel-vs-plain tests at the main path's shapes need
an NVIDIA card: they decide inside a fixture whether one is present and skip
without it (a skip is not a pass). `python3 chip_smoke.py` runs the same
comparisons on the card.
"""

import numpy as np
import pytest
import torch

from orb_slam2v2_1_tpu_torch import kernels
from orb_slam2v2_1_tpu_torch.ops import fast, hamming, image, matching

torch.set_num_threads(2)


@pytest.fixture
def rng():
    """Defined here as well, so the file also runs with --noconftest on a
    machine without jax (the shared conftest imports it)."""
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _features(rng, b, n, device="cpu"):
    words = hamming.words_from_uint32(rng.integers(0, 2**32, (b, n, 8), dtype=np.uint32))
    words[:, 5::7] = words[:, :1]  # duplicated descriptors: ties of the best distance
    xy = np.stack([rng.uniform(0, 640, (b, n)), rng.uniform(0, 480, (b, n))], -1).astype(np.float32)
    lvl = rng.integers(0, 8, (b, n)).astype(np.int32)
    valid = rng.uniform(size=(b, n)) > 0.1
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (words, xy, lvl, valid)]


class TestCpuPath:
    def test_library_path_is_content_keyed(self):
        path = kernels.library_path()
        assert path.parent == kernels.BUILD_DIR and path.name.endswith(".so")
        assert kernels.library_path() == path

    def test_cpu_tensors_take_plain_version_without_launching(self, rng, monkeypatch):
        def no_build(*a, **k):
            raise AssertionError("the CPU path must not build or load the kernels")

        monkeypatch.setattr(kernels, "_load", no_build)
        kernels.reset_launch_counts()
        img = torch.from_numpy(rng.uniform(0, 255, (40, 50)).astype(np.float32))
        assert torch.equal(fast.suppressed_score(img), fast.nms3(fast.fast_score(img)))
        q, t = _features(rng, 2, 30), _features(rng, 2, 40)
        r = torch.full((2, 30), 80.0)
        got = matching.masked_best_two(*q, r, *t)
        ref = matching.masked_best_two_plain(*q, r, *t)
        for g, e in zip(got, ref):
            assert torch.equal(g, e)
        assert kernels.LAUNCHES == {"fast_score_nms": 0, "masked_best_two": 0}

    def test_wrappers_refuse_cpu_tensors(self, rng, monkeypatch):
        monkeypatch.setattr(kernels, "_load", lambda: pytest.fail("checks come before the build"))
        with pytest.raises(ValueError, match="CUDA"):
            kernels.fast_score_nms(torch.zeros(8, 8))
        q, t = _features(rng, 1, 4), _features(rng, 1, 5)
        with pytest.raises(ValueError, match="CUDA"):
            kernels.masked_best_two(*q, torch.ones(1, 4), *t, -1, 1)


@pytest.mark.cuda
class TestOnCard:
    def test_fast_score_nms_all_levels(self, cuda_device, rng):
        """Bit-exact against the plain version over whole levels of a
        640x480 image, borders included."""
        img = torch.from_numpy(rng.uniform(0, 255, (480, 640)).astype(np.float32)).to(cuda_device)
        for lvl in image.build_pyramid(img, 8, 1.2):
            lvl = lvl.contiguous()
            got = kernels.fast_score_nms(lvl)
            torch.cuda.synchronize()
            assert torch.equal(got, fast.nms3(fast.fast_score(lvl)))

    @pytest.mark.parametrize("b,q,n", [(1, 1000, 1000), (1, 4096, 1000), (20, 1000, 1000), (3, 7, 5)])
    def test_masked_best_two_shapes(self, cuda_device, rng, b, q, n):
        """Exact: best and second everywhere, idx wherever a candidate exists
        (and 0 where none does, as the plain version)."""
        qf, tf = _features(rng, b, q, cuda_device), _features(rng, b, n, cuda_device)
        r = torch.from_numpy(rng.uniform(0, 60, (b, q)).astype(np.float32)).to(cuda_device)
        kernels.reset_launch_counts()
        got = matching.masked_best_two(*qf, r, *tf)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["masked_best_two"] == 1
        ref = matching.masked_best_two_plain(*qf, r, *tf)
        for g, e in zip(got, ref):
            assert torch.equal(g, e)

    def test_wrapper_checks(self, cuda_device, rng):
        with pytest.raises(ValueError, match="dtype"):
            kernels.fast_score_nms(torch.zeros(8, 8, dtype=torch.float64, device=cuda_device))
        with pytest.raises(ValueError, match="contiguous"):
            kernels.fast_score_nms(torch.zeros(8, 16, device=cuda_device)[:, ::2])
        q, t = _features(rng, 1, 4, cuda_device), _features(rng, 1, 5, cuda_device)
        with pytest.raises(ValueError, match="shape"):
            kernels.masked_best_two(*q, torch.ones(1, 3, device=cuda_device), *t, -1, 1)
