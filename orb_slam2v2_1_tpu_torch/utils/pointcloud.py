"""Dense point cloud, occupancy grid and octree export.

Port of the JAX package's `utils/pointcloud.py` (the reference's
`PointCloudMapping`, src/pointcloudmapping.cc: back-projection of every 3rd
RGB-D pixel, a 0.1 m voxel filter, an OctoMap-style export). `backproject`
runs on the depth's device; the voxel filter, the writers, the RANSAC plane
fit (numpy random numbers, as in the reference) and the octree are the
reference's numpy code, so their files are byte for byte the reference's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import device as device_mod
from .. import sync
from ..ops import lie


def backproject(depth: torch.Tensor, Tcw: torch.Tensor, K: torch.Tensor, stride: int = 3) -> torch.Tensor:
    """Depth (H, W) -> world points (ceil(H/s) * ceil(W/s), 3) on the depth's
    device, every `stride`-th pixel (src/pointcloudmapping.cc:92-104); rows
    without depth are NaN."""
    d = depth[::stride, ::stride]
    H, W = d.shape
    ys = (torch.arange(H, device=d.device) * stride).to(torch.float32)
    xs = (torch.arange(W, device=d.device) * stride).to(torch.float32)
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    z = d
    x = (u - K[2]) * z / K[0]
    y = (v - K[3]) * z / K[1]
    pc = torch.stack([x, y, z], -1).reshape(-1, 3)
    Twc = lie.se3_inverse(Tcw)
    pw = pc @ Twc[:3, :3].T + Twc[:3, 3]
    return torch.where(z.reshape(-1, 1) > 0, pw, float("nan"))


def voxel_downsample(points: np.ndarray, voxel: float = 0.1) -> np.ndarray:
    """Keep one point per voxel (the 0.1 m VoxelGrid filter analog)."""
    pts = points[np.isfinite(points).all(axis=1)]
    if len(pts) == 0:
        return pts
    keys = np.floor(pts / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return pts[np.sort(idx)]


def save_ply(points: np.ndarray, path: str | Path, colors: np.ndarray | None = None):
    pts = points[np.isfinite(points).all(axis=1)]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i, p in enumerate(pts):
            line = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if colors is not None:
                c = colors[i].astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")


def occupancy_grid(points: np.ndarray, voxel: float = 0.1):
    """Occupied-voxel set (the OctoMap `.bt` analog): returns (origin (3,),
    voxel size, (N,3) int voxel coords)."""
    pts = points[np.isfinite(points).all(axis=1)]
    if len(pts) == 0:
        return np.zeros(3), voxel, np.zeros((0, 3), np.int32)
    origin = pts.min(0)
    keys = np.floor((pts - origin) / voxel).astype(np.int32)
    occ = np.unique(keys, axis=0)
    return origin, voxel, occ


def save_occupancy(points: np.ndarray, path: str | Path, voxel: float = 0.1):
    origin, res, occ = occupancy_grid(points, voxel)
    np.savez_compressed(path, origin=origin, voxel=res, occupied=occ)


def export_sparse_map_ply(state, path: str | Path):
    """Sparse map-point cloud (the MapDrawer::DrawMapPoints data)."""
    pos, valid = sync.host_numpy(state.mp_pos, state.mp_valid)
    save_ply(pos[valid], path)


def fit_gravity_plane(points: np.ndarray, rng=None, iters: int = 200,
                      tol: float = 0.05):
    """RANSAC dominant-plane fit (the reference's gravity alignment,
    src/pointcloudmapping.cc:117-281: SACSegmentation on the merged cloud,
    then rotate the cloud so the floor is horizontal).

    Returns (normal (3,), d, inlier_mask) with the plane n.p + d = 0 and the
    normal oriented to +y-down convention flipped to point 'up' (-y in
    camera-world, since the first camera looks +z with +y down)."""
    rng = rng or np.random.default_rng(0)
    n_pts = points.shape[0]
    if n_pts < 3:
        return np.array([0.0, -1.0, 0.0]), 0.0, np.zeros(n_pts, bool)
    best = (None, 0.0, None)
    for _ in range(iters):
        idx = rng.choice(n_pts, 3, replace=False)
        p0, p1, p2 = points[idx]
        n = np.cross(p1 - p0, p2 - p0)
        nn = np.linalg.norm(n)
        if nn < 1e-9:
            continue
        n = n / nn
        d = -n @ p0
        inl = np.abs(points @ n + d) < tol
        if best[2] is None or inl.sum() > best[2].sum():
            best = (n, d, inl)
    n, d, inl = best
    # Refine on inliers (least-squares plane through centroid).
    pi = points[inl]
    c = pi.mean(0)
    _, _, Vt = np.linalg.svd(pi - c, full_matrices=False)
    n = Vt[-1]
    if n[1] > 0:  # orient 'up' (-y): camera convention has +y pointing down
        n = -n
    d = -n @ c
    inl = np.abs(points @ n + d) < tol
    return n.astype(np.float32), float(d), inl


def gravity_align(points: np.ndarray, rng=None):
    """Rotate the cloud so the RANSAC-dominant plane (the floor) becomes
    horizontal (normal -> -y). Returns (aligned_points, R (3,3))."""
    n, d, _ = fit_gravity_plane(points, rng)
    up = np.array([0.0, -1.0, 0.0], np.float32)
    v = np.cross(n, up)
    s = np.linalg.norm(v)
    c = float(n @ up)
    if s < 1e-9:
        R = np.eye(3, dtype=np.float32) if c > 0 else np.diag([1, -1, -1]).astype(np.float32)
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]],
                      np.float32)
        R = np.eye(3, dtype=np.float32) + vx + vx @ vx * ((1 - c) / (s * s))
    return points @ R.T, R


def build_octree(points: np.ndarray, res: float = 0.1):
    """Occupied-leaf octree over the cloud: nested dicts keyed by octant
    (0..7), leaves at voxel resolution — the .bt octree structure
    (src/pointcloudmapping.cc exports octomap::OcTree at 0.1 res)."""
    if points.shape[0] == 0:
        return {}, np.zeros(3, np.float32), res, 0
    lo = points.min(0)
    hi = points.max(0)
    extent = float(max(hi - lo)) + res
    depth = max(1, int(np.ceil(np.log2(extent / res))))
    size = res * (2**depth)
    center = (lo + hi) / 2.0
    origin = center - size / 2.0
    vox = np.unique(((points - origin) / res).astype(np.int64), axis=0)
    vox = np.clip(vox, 0, 2**depth - 1)
    root: dict = {}
    for v in vox:
        node = root
        for lvl in range(depth - 1, -1, -1):
            oct_i = (
                (int(v[0] >> lvl) & 1)
                | ((int(v[1] >> lvl) & 1) << 1)
                | ((int(v[2] >> lvl) & 1) << 2)
            )
            if lvl == 0:
                node[oct_i] = True  # occupied leaf
            else:
                node = node.setdefault(oct_i, {})
    return root, origin.astype(np.float32), res, depth


def save_octree(points: np.ndarray, path: str | Path, res: float = 0.1):
    """Serialize the occupied-leaf octree depth-first with 16-bit child
    masks (2 bits per child: 01 occupied leaf, 11 inner node — the octomap
    .bt encoding scheme), with an npz-readable header. Round-trips through
    `load_octree`."""
    root, origin, res, depth = build_octree(points, res)
    blob = bytearray()

    def emit(node):
        mask = 0
        for i in range(8):
            child = node.get(i)
            if child is True:
                mask |= 0b01 << (2 * i)
            elif isinstance(child, dict):
                mask |= 0b11 << (2 * i)
        blob.extend(mask.to_bytes(2, "little"))
        for i in range(8):
            child = node.get(i)
            if isinstance(child, dict):
                emit(child)

    if root:
        emit(root)
    np.savez_compressed(
        path,
        magic=np.bytes_("orbslam-octree-v1"),
        origin=origin,
        res=np.float32(res),
        depth=np.int32(depth),
        tree=np.frombuffer(bytes(blob), np.uint8),
    )


def load_octree(path) -> np.ndarray:
    """Decode occupied-leaf centers (N,3) from a saved octree."""
    data = np.load(path)
    origin = data["origin"]
    res = float(data["res"])
    depth = int(data["depth"])
    blob = data["tree"].tobytes()
    out = []
    pos = [0]

    def walk(x, y, z, lvl):
        if pos[0] + 2 > len(blob):
            return
        mask = int.from_bytes(blob[pos[0]: pos[0] + 2], "little")
        pos[0] += 2
        for i in range(8):
            bits = (mask >> (2 * i)) & 0b11
            cx = x | ((i & 1) << (lvl - 1))
            cy = y | (((i >> 1) & 1) << (lvl - 1))
            cz = z | (((i >> 2) & 1) << (lvl - 1))
            if bits == 0b01:
                out.append((cx, cy, cz))
            elif bits == 0b11:
                walk(cx, cy, cz, lvl - 1)

    if blob:
        walk(0, 0, 0, depth)
    if not out:
        return np.zeros((0, 3), np.float32)
    v = np.asarray(out, np.float64)
    return (origin + (v + 0.5) * res).astype(np.float32)


class DenseMapper:
    """Accumulating dense mapper (the PointCloudMapping analog): feed
    keyframe depth images, export the merged cloud and occupancy at the end
    (src/pointcloudmapping.cc:68-127, 117-281). Back-projection runs on
    `device` (None: the card)."""

    def __init__(self, K, voxel: float = 0.1, stride: int = 3, device=None):
        self.device = device_mod.resolve(device)
        self.K = torch.as_tensor(K, dtype=torch.float32).to(self.device)
        self.voxel = voxel
        self.stride = stride
        self.clouds: list[np.ndarray] = []

    def insert_keyframe(self, depth, Tcw):
        pw = backproject(torch.as_tensor(depth, dtype=torch.float32).to(self.device),
                         torch.as_tensor(Tcw, dtype=torch.float32).to(self.device), self.K, self.stride)
        (pts,) = sync.host_numpy(pw)
        self.clouds.append(voxel_downsample(pts, self.voxel))

    def global_cloud(self) -> np.ndarray:
        if not self.clouds:
            return np.zeros((0, 3), np.float32)
        return voxel_downsample(np.concatenate(self.clouds), self.voxel)

    def save(self, ply_path=None, occupancy_path=None):
        cloud = self.global_cloud()
        if ply_path:
            save_ply(cloud, ply_path)
        if occupancy_path:
            save_occupancy(cloud, occupancy_path, self.voxel)
        return cloud
