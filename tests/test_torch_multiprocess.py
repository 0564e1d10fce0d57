"""The sharded bundle adjustment across processes, on the CPU: the PyTorch
port's counterpart of the sharded-GBA half of tests/test_multiprocess.py.

Two OS processes join one `torch.distributed` group (gloo, rendezvous through
a `FileStore` under the test's `tmp_path`, so parallel test workers never
share a TCP port), each holding a mesh of 4 "cpu" shards: one mesh of 8
shards over both. Each builds the same seeded problem as the reference's
test (8 cameras, 256 points, 4096 stereo observations, seed 5), keeps its
half of the observations and runs the full LM schedule with cg_iters=32; every
reduction ends in one all-reduce over the group. Held to: both ranks return
the same poses and cost; the cost within 1% of the single-device engine
(`ops.ba.bundle_adjust`); the poses within 5e-3 of the in-process 8-shard
solve (a different order of the sums, see test_torch_dist_ba.py). Each child
runs on one thread.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from orb_slam2v2_1_tpu_torch.ops import ba
from orb_slam2v2_1_tpu_torch.parallel import dist_ba
from orb_slam2v2_1_tpu_torch.parallel.mesh import Mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300

PROBLEM = textwrap.dedent(
    """
    import numpy as np
    import torch

    from orb_slam2v2_1_tpu_torch.ops import ba


    def problem():
        rng = np.random.default_rng(5)
        C, Pn, O = 8, 256, 4096
        angles = np.linspace(0, 2 * np.pi, C, endpoint=False)
        poses = np.stack([np.eye(4, dtype=np.float32) for _ in angles])
        poses[:, 0, 3] = 0.1 * np.cos(angles)
        poses[:, 1, 3] = 0.1 * np.sin(angles)
        pts = rng.uniform(-1, 1, (Pn, 3)).astype(np.float32)
        pts[:, 2] += 4.0
        K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
        bf = 40.0
        cam_idx = rng.integers(0, C, O).astype(np.int32)
        pt_idx = rng.integers(0, Pn, O).astype(np.int32)
        Tc = poses[cam_idx]
        pc = np.einsum("oij,oj->oi", Tc[:, :3, :3], pts[pt_idx]) + Tc[:, :3, 3]
        u = K[0] * pc[:, 0] / pc[:, 2] + K[2]
        v = K[1] * pc[:, 1] / pc[:, 2] + K[3]
        target = np.stack([u, v, u - bf / pc[:, 2]], -1).astype(np.float32)
        target[:, :2] += rng.normal(0, 0.5, (O, 2))
        pts_noisy = (pts + rng.normal(0, 0.02, pts.shape)).astype(np.float32)
        cam_fixed = np.zeros(C, bool)
        cam_fixed[0] = True
        t = torch.from_numpy
        obs = ba.Obs(cam_idx=t(cam_idx), pt_idx=t(pt_idx), target=t(target), inv_sigma2=torch.ones(O),
                     is_stereo=torch.ones(O, dtype=torch.bool), valid=torch.ones(O, dtype=torch.bool))
        return ba.BAProblem(poses=t(poses), points=t(pts_noisy), obs=obs, cam_fixed=t(cam_fixed), K=t(K), bf=bf)
    """
)

WORKER = textwrap.dedent(
    """
    import sys

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, sys.argv[4])
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from orb_slam2v2_1_tpu_torch.ops import ba
    from orb_slam2v2_1_tpu_torch.parallel import dist_ba
    from orb_slam2v2_1_tpu_torch.parallel.mesh import Mesh
    from problem import problem

    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    prob = problem()
    half = prob.obs.cam_idx.shape[0] // 2
    local = ba.Obs(*(f[rank * half:(rank + 1) * half] for f in prob.obs))
    mesh = Mesh(["cpu"] * 4, group=dist.group.WORLD)
    assert mesh.size == 8 and mesh.n_local == 4
    poses, points, valid, cost = dist_ba.make_sharded_bundle_adjust(mesh, cg_iters=32)(
        prob.poses, prob.points, local, prob.cam_fixed, prob.K, prob.bf)
    np.savez(out, poses=poses.numpy(), points=points.numpy(), valid=valid.numpy(), cost=float(cost))
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: cost {float(cost):.4f} OK", flush=True)
    """
)


def _problem(tmp_path):
    (tmp_path / "problem.py").write_text(PROBLEM)
    sys.path.insert(0, str(tmp_path))
    try:
        from problem import problem
        return problem()
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("problem", None)


def test_two_process_sharded_gba(tmp_path):
    prob = _problem(tmp_path)
    (tmp_path / "worker.py").write_text(WORKER)
    store = str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=str(tmp_path), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"), str(rank), store,
                               str(tmp_path / f"rank{rank}.npz"), ROOT],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
             for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"rank {rank}: cost" in out
    r0, r1 = (np.load(tmp_path / f"rank{rank}.npz") for rank in (0, 1))
    np.testing.assert_array_equal(r0["poses"], r1["poses"])
    assert float(r0["cost"]) == float(r1["cost"])

    _, cost_single = ba.bundle_adjust(prob, cg_iters=32)
    rel = abs(float(r0["cost"]) - float(cost_single)) / float(cost_single)
    assert rel < 0.01, (float(r0["cost"]), float(cost_single))
    in_process = dist_ba.make_sharded_bundle_adjust(Mesh(["cpu"] * 8), cg_iters=32)(*prob[:4], prob.K, prob.bf)
    np.testing.assert_allclose(r0["poses"], in_process[0].numpy(), atol=5e-3)
    assert r0["valid"].shape == r1["valid"].shape == (2048,)  # each rank's own observations
    assert np.isfinite(r0["points"]).all() and torch.isfinite(in_process[1]).all()
