"""The port's motion-only pose optimization on the CPU.

`ops.ba.pose_optimization` on CPU tensors takes the plain LM loop (on CUDA
tensors it is one launch of `kernels.pose_lm`). These fix the cases of
`torch_pose_problems.CASES`, which the card tests of the kernel in
`tests/test_torch_kernels.py` run through: the exit patterns the kernel has
to reproduce (every round ending in its first iteration, a round stopped by
the iteration cap, nothing valid and every step rejected).
"""

import pytest
import torch

import torch_pose_problems as pose
from orb_slam2v2_1_tpu_torch import kernels, sync
from orb_slam2v2_1_tpu_torch.ops import ba
from orb_slam2v2_1_tpu_torch.ops import lie

torch.set_num_threads(2)


class TestPortPoseOptimizationOnCpu:
    def test_cpu_takes_plain_path_reading_once_per_iteration(self, monkeypatch):
        monkeypatch.setattr(kernels, "_load", lambda src: pytest.fail("the CPU path must not build or load a kernel"))
        steps = []
        exp = lie.se3_exp

        def counted_exp(xi):
            steps.append(1)
            return exp(xi)

        args = pose.pose_problem(0, 300)
        monkeypatch.setattr(lie, "se3_exp", counted_exp)
        kernels.reset_launch_counts()
        reads = sync.COUNT["syncs"]
        T, mask, n = ba.pose_optimization(*args)
        n_reads = sync.COUNT["syncs"] - reads
        assert n_reads == len(steps) and 4 <= n_reads <= 40
        assert kernels.LAUNCHES["pose_lm"] == 0
        ref = ba.pose_optimization_plain(*args)
        assert torch.equal(T, ref[0]) and torch.equal(mask, ref[1]) and torch.equal(n, ref[2])

    def test_first_iteration_exit_case(self):
        (_, mask, n), flags = pose.exit_flags(*pose.CASES["first_iteration_exit"]())
        assert flags == [True] * 4 and int(n) == int(mask.sum()) > 900

    def test_capped_far_case_stops_at_the_cap(self):
        iters = pose.ITERS["capped_far"]
        (_, mask, n), flags = pose.exit_flags(*pose.CASES["capped_far"](), iters=iters)
        rounds = pose.rounds_of(flags, iters)
        assert len(rounds) == 4 and rounds[0] == [False] * iters and int(n) == int(mask.sum()) > 700
        # uncapped, round 0 needs more: the cap stopped a descent
        _, flags10 = pose.exit_flags(*pose.CASES["capped_far"]())
        assert len(pose.rounds_of(flags10)[0]) > iters

    def test_all_invalid_case_runs_every_iteration_and_keeps_the_pose(self):
        T0, pts, obs, K, bf = pose.CASES["all_invalid"]()
        T0 = lie.se3_exp(torch.tensor([0.05, -0.03, 0.02, 0.01, -0.02, 0.015])) @ T0
        (T, mask, n), flags = pose.exit_flags(T0, pts, obs, K, bf)
        assert flags == [False] * 40 and not mask.any() and int(n) == 0
        assert torch.equal(T, lie.orthonormalize(T0))
