"""The hand-written CUDA kernels' wrappers and their device dispatch.

On the CPU (this suite's default) the dispatching functions
`ops.fast.suppressed_score` / `suppressed_cells_pyramid`,
`ops.matching.masked_best_two` / `match_projection` and
`ops.ba.pose_optimization` run the plain PyTorch versions and never reach
`kernels`; the wrappers in `kernels` accept CUDA tensors only. The entry
points that create tensors default to the card and raise without one. The
kernel-vs-plain tests at the main path's shapes need
an NVIDIA card: they decide inside a fixture whether one is present and skip
without it (a skip is not a pass). `python3 chip_smoke.py` runs the same
comparisons on the card.
"""

import numpy as np
import pytest
import torch

from orb_slam2v2_1_tpu_torch import kernel_times, kernels, sync
from orb_slam2v2_1_tpu_torch.ops import ba, fast, hamming, image, matching
import torch_pose_problems as pose

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


def _pyramid(rng, device="cpu", shape=(480, 640), noise=True):
    """Levels of an 8-level pyramid over uniform noise (ties of 0 and empty
    cells are common after thresholding) or over a smooth texture."""
    img = rng.uniform(0, 255, shape).astype(np.float32)
    if not noise:
        from scipy.ndimage import gaussian_filter

        img = np.clip(gaussian_filter(img - 128, 2.0) * 12 + 128, 0, 255).astype(np.float32)
    return [lvl.contiguous() for lvl in image.build_pyramid(torch.from_numpy(img).to(device), 8, 1.2)]


# The main path's three shapes, then ragged ones: a few queries, three target
# tiles (the double buffer is reused), and an odd query count in each of the
# kernel's regimes (under 2048 queries, under 8192, above); then the KITTI
# geometry's (2000 features): motion model, local map, batched fuse.
SEARCH_SHAPES = [(1, 1000, 1000), (1, 4096, 1000), (20, 1000, 1000), (3, 7, 5), (2, 50, 1031),
                 (1, 2501, 1500), (3, 3001, 700), (1, 2000, 2000), (1, 4096, 2000), (20, 2000, 2000)]
RANK = dict(cell=16, border=19, threshold=20.0, min_threshold=7.0)


class TestCpuPath:
    def test_library_path_is_content_keyed(self):
        paths = [kernels.library_path(src) for src in kernels.SOURCES]
        assert len(set(paths)) == len(kernels.SOURCES)
        for src, path in zip(kernels.SOURCES, paths):
            assert path.parent == kernels.BUILD_DIR and path.name.endswith(".so")
            assert kernels.library_path(src) == path

    def test_cpu_tensors_take_plain_version_without_launching(self, rng, monkeypatch):
        def no_build(*a, **k):
            raise AssertionError("the CPU path must not build or load the kernels")

        monkeypatch.setattr(kernels, "_load", no_build)
        kernels.reset_launch_counts()
        img = torch.from_numpy(rng.uniform(0, 255, (40, 50)).astype(np.float32))
        assert torch.equal(fast.suppressed_score(img), fast.nms3(fast.fast_score(img)))
        best, arg = fast.suppressed_cells_pyramid([img], **RANK).level(0)
        ref_best, ref_arg = fast.rank_cells(fast.nms3(fast.fast_score(img)), **RANK)
        assert torch.equal(best, ref_best) and torch.equal(arg, ref_arg)
        q, t = _features(rng, 2, 30), _features(rng, 2, 40)
        r = torch.full((2, 30), 80.0)
        got = matching.masked_best_two(*q, r, *t)
        ref = matching.masked_best_two_plain(*q, r, *t)
        for g, e in zip(got, ref):
            assert torch.equal(g, e)
        m = matching.match_projection(*q, *t, r, max_dist=120, nn_ratio=0.95)
        e = matching.match_projection_plain(*q, *t, r, max_dist=120, nn_ratio=0.95)
        assert torch.equal(m.ok, e.ok) and torch.equal(m.dist, e.dist) and torch.equal(m.idx, e.idx)
        args = pose.pose_problem(0, 200)
        got, ref = ba.pose_optimization(*args), ba.pose_optimization_plain(*args)
        for g, e in zip(got, ref):
            assert torch.equal(g, e)
        assert kernels.LAUNCHES == {"fast_score_nms": 0, "masked_best_two": 0, "pose_lm": 0}

    @pytest.mark.parametrize("wrapper", ["fast_score_nms", "fast_cells_pyramid", "masked_best_two", "masked_match",
                                         "pose_lm"])
    def test_wrappers_refuse_cpu_tensors(self, rng, monkeypatch, wrapper):
        monkeypatch.setattr(kernels, "_load", lambda src: pytest.fail("checks come before the build"))
        q, t = _features(rng, 1, 4), _features(rng, 1, 5)
        T0, pts, obs, K, bf = pose.pose_problem(0, 20)
        calls = {
            "fast_score_nms": lambda: kernels.fast_score_nms(torch.zeros(8, 8)),
            "fast_cells_pyramid": lambda: kernels.fast_cells_pyramid([torch.zeros(40, 40)], 16, 19, 20.0, 7.0),
            "masked_best_two": lambda: kernels.masked_best_two(*q, torch.ones(1, 4), *t, -1, 1),
            "masked_match": lambda: kernels.masked_match(*q, torch.ones(1, 4), *t, -1, 1, 100, 0.9),
            "pose_lm": lambda: kernels.pose_lm(T0, pts, *obs[1:], K, bf),
        }
        with pytest.raises(ValueError, match="CUDA"):
            calls[wrapper]()

    @pytest.mark.parametrize("bad", ["Tcw0_float64", "pt_idx_int64", "valid_uint8", "target_strided",
                                     "points_strided", "target_shape", "K_shape", "bf_tensor", "rounds_negative",
                                     "over_2048_observations"])
    def test_pose_lm_refuses_wrong_dtype_layout_and_arguments(self, monkeypatch, bad):
        """The wrapper checks type, shape and layout before the device, so
        these refusals show on CPU tensors too, and before any build."""
        monkeypatch.setattr(kernels, "_load", lambda src: pytest.fail("checks come before the build"))
        T0, pts, obs, K, bf = pose.pose_problem(0, 20)
        w0, wpts, wobs, wK, wbf = pose.pose_problem(0, kernels.POSE_MAX_OBS + 1)
        wide = (w0, wpts, wobs.pt_idx, wobs.target, wobs.inv_sigma2, wobs.is_stereo, wobs.valid, wK, wbf)
        args = dict(Tcw0=T0, points=pts, pt_idx=obs.pt_idx, target=obs.target, inv_sigma2=obs.inv_sigma2,
                    is_stereo=obs.is_stereo, valid=obs.valid, K=K, bf=bf, rounds=4, iters=10)
        change, error, match = {
            "Tcw0_float64": (dict(Tcw0=T0.double()), ValueError, "dtype"),
            "pt_idx_int64": (dict(pt_idx=obs.pt_idx.long()), ValueError, "dtype"),
            "valid_uint8": (dict(valid=obs.valid.to(torch.uint8)), ValueError, "dtype"),
            "target_strided": (dict(target=torch.cat([obs.target, obs.target], 1)[:, ::2]), ValueError, "contiguous"),
            "points_strided": (dict(points=pts.t().contiguous().t()), ValueError, "contiguous"),
            "target_shape": (dict(target=obs.target[:, :2].contiguous()), ValueError, "shape"),
            "K_shape": (dict(K=torch.cat([K, K])), ValueError, "shape"),
            "bf_tensor": (dict(bf=torch.tensor(bf)), TypeError, "bf"),
            "rounds_negative": (dict(rounds=-1), ValueError, "rounds"),
            "over_2048_observations": (dict(zip(("Tcw0", "points", "pt_idx", "target", "inv_sigma2", "is_stereo",
                                                 "valid", "K", "bf"), wide)), ValueError, "at most 2048"),
        }[bad]
        with pytest.raises(error, match=match):
            kernels.pose_lm(**{**args, **change})

    def test_sources_and_counters_list_pose_lm(self):
        """The kernel builds in the same parallel nvcc batch as the others
        and is counted like them."""
        assert "pose_lm.cu" in kernels.SOURCES
        assert (kernels.CSRC / "pose_lm.cu").is_file()
        assert isinstance(kernels.LAUNCHES["pose_lm"], int) and "pose_lm" in kernels.LAUNCHES_BY_ROLE

    def test_cell_form_refuses_other_cells_and_too_many_levels(self):
        with pytest.raises(ValueError, match="cell"):
            kernels.fast_cells_pyramid([torch.zeros(40, 40)], 8, 19, 20.0, 7.0)
        with pytest.raises(ValueError, match="levels"):
            kernels.fast_cells_pyramid([torch.zeros(40, 40)] * 17, 16, 19, 20.0, 7.0)


def _entry_points():
    """Each entry point that creates tensors, as a call taking `device`."""
    from orb_slam2v2_1_tpu_torch.models import map_state, offline, system, tracking
    from orb_slam2v2_1_tpu_torch.utils import config, synthetic

    # Three levels: at 96x80 the eighth would be smaller than the 39-px ORB
    # patch, which raises in both packages.
    cfg = config.SlamConfig(fx=60.0, fy=60.0, cx=48.0, cy=40.0, width=96, height=80, n_features=100,
                            n_levels=3, max_keyframes=4, max_map_points=256, bf=10.0)
    rng = np.random.default_rng(3)
    state_np = map_state.to_numpy(map_state.empty_map(2, 16, 8, device="cpu"))
    frame_np = {name: np.zeros((4, 8) if name == "desc" else (4, 2) if name == "xy" else (4,),
                               np.uint32 if name == "desc" else np.float32)
                for name in tracking.FrameData._fields}
    frames = np.zeros((2, 80, 96), np.float32)

    def track(device):
        # The device is resolved before any frame is touched; on the CPU the
        # blank frames then fail in map initialization or run through.
        return offline.track_sequence_rgbd(frames, frames + 1.0, cfg, device=device)

    def slam(device, sensor=system.Sensor.RGBD):
        return system.SlamSystem(config=cfg, sensor=sensor, device=device).map.kf_pose.device

    return {
        "SlamSystem": slam,
        "SlamSystem_mono": lambda device: slam(device, system.Sensor.MONOCULAR),
        "make_desk": lambda device: synthetic.make_desk(rng, tex_size=16, device=device).tex.device,
        "desk_frames": lambda device: synthetic.desk_frames(cfg, synthetic.lateral_trajectory(2), device=device)[0].device,
        "make_room": lambda device: synthetic.make_room(rng, tex_size=16, device=device).tex.device,
        "orbit_frames": lambda device: synthetic.orbit_frames(cfg, 1, device=device)[0].device,
        "empty_map": lambda device: map_state.empty_map(2, 16, 8, device=device).kf_pose.device,
        "from_numpy": lambda device: map_state.from_numpy(state_np, device=device).kf_pose.device,
        "frame_from_numpy": lambda device: tracking.frame_from_numpy(frame_np, device=device).xy.device,
        "track_sequence_rgbd": track,
    }


class TestDeviceDefault:
    """Entry points run on the card unless asked for the CPU: with no device
    given and no card they raise; they do not carry on on the CPU."""

    @pytest.mark.parametrize("name", ["make_room", "orbit_frames", "empty_map", "from_numpy",
                                      "frame_from_numpy", "track_sequence_rgbd", "SlamSystem",
                                      "SlamSystem_mono", "make_desk", "desk_frames"])
    def test_raises_without_card_and_runs_on_cpu(self, monkeypatch, name):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        call = _entry_points()[name]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None)
        out = call("cpu")
        if name == "track_sequence_rgbd":
            poses, ok, state = out
            assert poses.shape == (2, 4, 4) and state.kf_pose.device.type == "cpu"
        else:
            assert out.type == "cpu"

    def test_tensors_stay_where_they_are(self, monkeypatch):
        """Frames given as tensors decide the device; no card is asked for."""
        from orb_slam2v2_1_tpu_torch.models import offline
        from orb_slam2v2_1_tpu_torch.utils import config

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = config.SlamConfig(fx=60.0, fy=60.0, cx=48.0, cy=40.0, width=96, height=80, n_features=100,
                                n_levels=3, max_keyframes=4, max_map_points=256, bf=10.0)
        frames = torch.zeros((2, 80, 96))
        _, _, state = offline.track_sequence_rgbd(frames, frames + 1.0, cfg)
        assert state.kf_pose.device.type == "cpu"


def _assert_match_equal(got, ref):
    """ok and dist everywhere, idx where ok (elsewhere it is undefined)."""
    assert torch.equal(got.ok, ref.ok) and torch.equal(got.dist, ref.dist)
    assert torch.equal(got.idx[ref.ok], ref.idx[ref.ok])


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("shape", [(480, 640), (376, 1241)])
    def test_fast_score_nms_all_levels(self, cuda_device, rng, shape):
        """Bit-exact against the plain version over whole levels of a
        640x480 and a KITTI 1241x376 image (no level width a multiple of 16
        bytes), borders included."""
        for lvl in _pyramid(rng, cuda_device, shape):
            got = kernels.fast_score_nms(lvl)
            torch.cuda.synchronize()
            assert torch.equal(got, fast.nms3(fast.fast_score(lvl)))

    @pytest.mark.parametrize("noise", [True, False])
    @pytest.mark.parametrize("shape", [(480, 640), (97, 133), (376, 1241)])
    def test_fast_cells_pyramid(self, cuda_device, rng, shape, noise):
        """The cell form, one launch for all levels, bit-exact against
        `rank_cells` of the plain suppressed score: ties and empty cells
        (noise), ragged edges (no level is a multiple of 16)."""
        levels = _pyramid(rng, cuda_device, shape, noise)
        kernels.reset_launch_counts()
        got = fast.suppressed_cells_pyramid(levels, **RANK)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["fast_score_nms"] == 1
        for l, lvl in enumerate(levels):
            best, arg = got.level(l)
            ref_best, ref_arg = fast.rank_cells(fast.nms3(fast.fast_score(lvl)), **RANK)
            assert torch.equal(best, ref_best) and torch.equal(arg, ref_arg)
            assert not got.best[l, best.numel():].any()  # the row's padding is zero

    @pytest.mark.parametrize("b,q,n", SEARCH_SHAPES)
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

    @pytest.mark.parametrize("b,q,n", SEARCH_SHAPES)
    def test_match_projection_shapes(self, cuda_device, rng, b, q, n):
        """The match form against the plain path on the same tensors: many
        queries share a best target (duplicated descriptors), so the
        one-to-one resolution and its tie rule are exercised."""
        qf, tf = _features(rng, b, q, cuda_device), _features(rng, b, n, cuda_device)
        r = torch.from_numpy(rng.uniform(0, 60, (b, q)).astype(np.float32)).to(cuda_device)
        kernels.reset_launch_counts()
        got = matching.match_projection(*qf, *tf, r, max_dist=120, nn_ratio=0.95)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["masked_best_two"] == 1
        ref = matching.match_projection_plain(*qf, *tf, r, max_dist=120, nn_ratio=0.95)
        _assert_match_equal(got, ref)

    @pytest.mark.parametrize("b,q,n,max_dist", [(1, 1000, 1000, 100), (16, 4096, 1000, 50)], ids=["sim3", "loop_fuse"])
    def test_match_projection_loop_shapes(self, cuda_device, rng, b, q, n, max_dist):
        """Loop closing's searches at ratio 1.0: one Sim3 candidate's projection
        search, and the loop fusion with the same queries expanded over the
        16 target keyframes (an expanded view, as `search_and_fuse` passes
        it). Both forms exact."""
        qf, tf = _features(rng, 1, q, cuda_device), _features(rng, b, n, cuda_device)
        qf = [x.expand((b,) + x.shape[1:]) for x in qf]
        r = torch.from_numpy(rng.uniform(5, 60, (b, q)).astype(np.float32)).to(cuda_device)
        kernels.reset_launch_counts()
        got = matching.match_projection(*qf, *tf, r, max_dist=max_dist, nn_ratio=1.0)
        best = matching.masked_best_two(*qf, r, *tf)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["masked_best_two"] == 2
        _assert_match_equal(got, matching.match_projection_plain(*qf, *tf, r, max_dist=max_dist, nn_ratio=1.0))
        for g, e in zip(best, matching.masked_best_two_plain(*qf, r, *tf)):
            assert torch.equal(g, e)

    def test_wrapper_checks(self, cuda_device, rng):
        with pytest.raises(ValueError, match="dtype"):
            kernels.fast_score_nms(torch.zeros(8, 8, dtype=torch.float64, device=cuda_device))
        with pytest.raises(ValueError, match="contiguous"):
            kernels.fast_score_nms(torch.zeros(8, 16, device=cuda_device)[:, ::2])
        q, t = _features(rng, 1, 4, cuda_device), _features(rng, 1, 5, cuda_device)
        with pytest.raises(ValueError, match="shape"):
            kernels.masked_best_two(*q, torch.ones(1, 3, device=cuda_device), *t, -1, 1)
        with pytest.raises(ValueError, match="max_dist"):
            kernels.masked_match(*q, torch.ones(1, 4, device=cuda_device), *t, -1, 1, 1 << 20, 0.9)

    def test_relocalization_on_card(self, cuda_device):
        """`relocalization._match_and_pnp` on the card (its guided search is
        kernel 2's match form, 1 x 500 x 500 at ratio 1.0) against the CPU
        plain path, on a map the port built on the CPU from frames 0-11 of
        the orbit at 320x240 and frame 8 as the query, with the same
        hypothesis sets: the same verdict, inliers within 2, pose within
        1 mm / 0.05 deg."""
        from orb_slam2v2_1_tpu_torch.models import frontend, map_state, offline, relocalization, tracking
        from orb_slam2v2_1_tpu_torch.ops import orb, pnp, prng
        from orb_slam2v2_1_tpu_torch.utils import config, synthetic

        cfg = config.SlamConfig(fx=275.0, fy=275.0, cx=160.0, cy=120.0, width=320, height=240, n_features=500,
                                max_keyframes=16, max_map_points=4096, fps=3.0, bf=44.0, th_depth=100.0)
        imgs, deps, _ = synthetic.orbit_frames(cfg, 12, device="cpu", total=321)
        _, ok, state = offline.track_sequence_rgbd(imgs.numpy(), deps.numpy(), cfg, device="cpu")
        assert ok.all()
        K = torch.tensor(cfg.K)
        frame = frontend.build_frame_only(imgs[8], deps[8], K, torch.zeros(5), 44.0, torch.tensor(40, dtype=torch.int32),
                                          orb.OrbConfig(n_features=500), cfg.width, cfg.height)
        kf = int(torch.argmax((state.kf_frame_id == 9).to(torch.int32)))

        def sets(valid):
            return pnp.sample_sets(valid.cpu(), prng.key(7)).to(valid.device)

        ref = relocalization._match_and_pnp(state, frame, kf, K, 44.0, sets=sets)
        g_state = map_state.from_numpy(map_state.to_numpy(state), device=cuda_device)
        g_frame = tracking.frame_from_numpy(tracking.frame_to_numpy(frame), device=cuda_device)
        kernels.reset_launch_counts()
        got = relocalization._match_and_pnp(g_state, g_frame, kf, K.to(cuda_device), 44.0, sets=sets)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["masked_best_two"] == 1
        assert bool(got[0]) == bool(ref[0]) and int(ref[3]) >= 50
        assert abs(int(got[3]) - int(ref[3])) <= 2
        Tg, Tr = got[1].cpu().double().numpy(), ref[1].double().numpy()
        assert np.linalg.norm(Tg[:3, :3].T @ Tg[:3, 3] - Tr[:3, :3].T @ Tr[:3, 3]) <= 1e-3
        assert np.degrees(np.arccos(np.clip((np.trace(Tg[:3, :3].T @ Tr[:3, :3]) - 1) / 2, -1, 1))) <= 0.05

    def test_pnp_eigh_on_card(self, cuda_device, rng):
        """The batched float64 eigen solve of the DLT on the card against the
        CPU: the same inlier sets for well-conditioned (exact) samples."""
        from orb_slam2v2_1_tpu_torch.ops import pnp, prng

        n = 300
        pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 6, n)], -1)
        uv = np.stack([300 * pc[:, 0] / pc[:, 2] + 160, 300 * pc[:, 1] / pc[:, 2] + 120], -1)
        uv[::5] = rng.uniform([0, 0], [320, 240], (n // 5, 2))
        args = [torch.from_numpy(a.astype(np.float32)) for a in (pc, uv, np.ones(n), np.ones(n))]
        args[3] = args[3] > 0
        K = torch.tensor([300.0, 300.0, 160.0, 120.0])
        sets = pnp.sample_sets(args[3], prng.key(1))
        ref = pnp.pnp_ransac(*args, K, sets=sets)
        got = pnp.pnp_ransac(*(a.to(cuda_device) for a in args), K.to(cuda_device), sets=sets.to(cuda_device))
        assert bool(got.success) and bool(ref.success) and int(got.n_inliers) == int(ref.n_inliers) == 240
        assert torch.equal(got.inliers.cpu(), ref.inliers)
        np.testing.assert_allclose(got.Tcw.cpu().numpy(), ref.Tcw.numpy(), atol=1e-4)


def _on(device, T0, pts, obs, K, bf):
    return T0.to(device), pts.to(device), ba.Obs(*(x.to(device) for x in obs)), K.to(device), bf


def _flat(args):
    """`kernels.pose_lm`'s positional inputs from a problem on the card."""
    T0, pts, obs, K, bf = args
    return T0, pts, obs.pt_idx, obs.target, obs.inv_sigma2, obs.is_stereo, obs.valid, K, bf


@pytest.mark.cuda
class TestPoseLmOnCard:
    """Kernel 3 (`kernels.pose_lm`, through `ops.ba.pose_optimization`)
    against its plain version on the card, on the cases of
    `torch_pose_problems.CASES`."""

    @pytest.mark.parametrize("case", list(pose.CASES))
    def test_against_plain(self, cuda_device, case):
        """Tolerances, all from the sums running in another order (per
        observation over the three rows, then a fixed tree over threads,
        against the plain version's matrix products): the pose within 1e-4;
        the inlier masks equal except for observations whose chi2 at the
        plain pose lies within 1e-4 (relative) of its threshold; n_inliers
        the count of the kernel's own mask. Two calls agree bit for bit."""
        args = _on(cuda_device, *pose.CASES[case]())
        iters = pose.ITERS.get(case, 10)
        (ref_T, ref_mask, ref_n), flags = pose.exit_flags(*args, iters=iters)
        kernels.reset_launch_counts()
        got = ba.pose_optimization(*args, iters=iters)
        again = ba.pose_optimization(*args, iters=iters)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["pose_lm"] == 2
        for g, a in zip(got, again):
            assert torch.equal(g, a)
        T, mask, n = got
        # The kernel's own iteration count per round: each round within the
        # cap; where the plain version's exits are fixed by the case (each
        # round ending in its first iteration, a round cut by the cap,
        # nothing valid), the same.
        ran = kernels.pose_lm(*_flat(args), iters=iters)[3].cpu().tolist()
        plain = [len(r) for r in pose.rounds_of(flags, iters)]
        assert len(plain) == 4 and all(1 <= k <= iters for k in ran), (ran, plain)
        if case in ("first_iteration_exit", "all_invalid"):
            assert ran == plain, (ran, plain)
        if case == "capped_far":
            assert ran[0] == plain[0] == iters, (ran, plain)
        assert T.dtype == torch.float32 and mask.dtype == torch.bool and n.dtype == torch.int32 and n.dim() == 0
        np.testing.assert_allclose(T.cpu().numpy(), ref_T.cpu().numpy(), atol=1e-4)
        assert torch.equal(T[3].cpu(), torch.tensor([0.0, 0.0, 0.0, 1.0]))
        near = kernel_times.pose_near_threshold(ref_T, *args[1:])
        differ = (mask != ref_mask).cpu().numpy()
        assert not (differ & ~near).any(), f"{int((differ & ~near).sum())} inlier flags differ away from the threshold"
        assert int(n) == int(mask.sum())
        if not differ.any():
            assert int(n) == int(ref_n)

    def test_one_launch_no_read_no_sync(self, cuda_device):
        """A call on the card launches `pose_lm` once and at most 30 kernels
        in all, reads nothing through `sync`, and makes no implicit
        synchronization (sync debug mode "error" raises on one)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        args = _on(cuda_device, *pose.CASES["rgbd_1000"]())
        ba.pose_optimization(*args)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        reads = sync.COUNT["syncs"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = ba.pose_optimization(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        assert sync.COUNT["syncs"] == reads and kernels.LAUNCHES["pose_lm"] == 1
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        n_kernels = sum(e.count for e in rows if "memcpy" not in e.key.lower() and "memset" not in e.key.lower())
        assert sum(e.count for e in rows if "pose_lm" in e.key) == 1, [e.key for e in rows]
        assert 1 <= n_kernels <= 30, [(e.key, e.count) for e in rows]
        assert out[0].is_cuda and out[1].is_cuda and out[2].is_cuda
