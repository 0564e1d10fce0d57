"""Dataset loaders: TUM RGB-D, EuRoC stereo and KITTI odometry.

Port of the JAX package's `utils/datasets.py` (the file-based stand-in for
the reference's ROS-topic ingestion, src/ros_rgbd.cc): the loaders pair
frames by timestamp (TUM within 0.02 s, EuRoC within 5 ms) and read the
ground truth as {time: Twc (4,4)}, quaternions through the port's
`lie.quat_to_rot` in float32 as the reference does.

The reference reads PNGs with PIL. The port needs no imaging library: `read_png`
decodes a non-interlaced PNG of 8-bit gray, gray + alpha, RGB or RGBA, or
16-bit gray, with all five row filters, into the array `np.asarray(PIL.Image.open(path))`
gives. `write_tum_rgbd` writes a TUM-layout directory (RGB and 16-bit depth
PNGs, `rgb.txt`, `depth.txt`, `groundtruth.txt`) from rendered frames.
"""

from __future__ import annotations

import re
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from ..ops import lie

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> channels (0 gray, 2 RGB, 4 gray + alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _read_tum_list(path: Path):
    out = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        out.append((float(parts[0]), parts[1]))
    return out


def _quat_pose(t_xyz, q_xyzw) -> np.ndarray:
    """Twc (4,4) float64 from a translation and a quaternion (x, y, z, w),
    the rotation computed in float32."""
    R = lie.quat_to_rot(torch.tensor(q_xyzw, dtype=torch.float32)).numpy()
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t_xyz
    return T


def load_tum_rgbd(root: str | Path, max_dt: float = 0.02):
    """A TUM fr1-style directory (rgb.txt, depth.txt, groundtruth.txt).
    Returns (pairs [{t, rgb, depth}], gt {t: Twc (4,4)}): each RGB frame
    with the depth frame nearest in time, kept when within max_dt."""
    root = Path(root)
    rgb = _read_tum_list(root / "rgb.txt")
    depth = _read_tum_list(root / "depth.txt")
    d_times = np.array([t for t, _ in depth])

    pairs = []
    for t, rgb_path in rgb:
        j = int(np.argmin(np.abs(d_times - t)))
        if abs(d_times[j] - t) <= max_dt:
            pairs.append({"t": t, "rgb": root / rgb_path, "depth": root / depth[j][1]})

    gt = {}
    gt_file = root / "groundtruth.txt"
    if gt_file.exists():
        for line in gt_file.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, tx, ty, tz, qx, qy, qz, qw = [float(x) for x in line.split()][:8]
            gt[t] = _quat_pose([tx, ty, tz], [qx, qy, qz, qw])
    return pairs, gt


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters: raw (H, stride) filtered bytes, ftype (H,).
    Rows of filters None / Sub / Up are decoded a row at a time. Average and
    Paeth depend on the byte bpp to the left as well as on the row above, so
    an image with either is decoded along anti-diagonals of pixels, each
    diagonal one vectorized step, every row under its own filter."""
    H, stride = raw.shape
    W = stride // bpp
    x = raw.astype(np.int64).reshape(H, W, bpp)
    if np.all(ftype <= 2):
        out = np.zeros((H, W, bpp), np.int64)
        prior = np.zeros((W, bpp), np.int64)
        for r in range(H):
            f = ftype[r]
            row = x[r]
            if f == 1:
                row = np.cumsum(row, axis=0)
            elif f == 2:
                row = row + prior
            out[r] = prior = row & 0xFF
        return out.reshape(H, stride).astype(np.uint8)
    out = np.zeros((H + 1, W + 1, bpp), np.int64)  # a zero row above and column left
    for t in range(H + W - 1):
        r = np.arange(max(0, t - W + 1), min(H, t + 1))
        c = t - r
        a, b, cc = out[r + 1, c], out[r, c + 1], out[r, c]
        f = ftype[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, _paeth(a, b, cc)], 0)
        out[r + 1, c + 1] = (x[r, c] + pred) & 0xFF
    return out[1:, 1:].reshape(H, stride).astype(np.uint8)


def read_png(path) -> np.ndarray:
    """A PNG as the array PIL gives: (H, W) uint8 gray, (H, W, C) uint8 for
    gray + alpha / RGB / RGBA, (H, W) uint16 for 16-bit gray. Raises
    ValueError on anything else (palette, interlace, other bit depths)."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if ctype not in _CHANNELS or depth not in (8, 16) or (depth == 16 and ctype != 0):
        raise ValueError(f"{path}: PNG of bit depth {depth}, color type {ctype} is not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[: h * (stride + 1)].reshape(h, stride + 1)
    if np.any(rows[:, 0] > 4):
        raise ValueError(f"{path}: unknown PNG row filter")
    px = _unfilter(rows[:, 1:], rows[:, 0], bpp)
    if depth == 16:
        return px.view(">u2").astype(np.uint16).reshape(h, w)
    return px.reshape(h, w) if ch == 1 else px.reshape(h, w, ch)


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes (no row filter) of an (H, W) uint8 gray, (H, W) uint16
    gray or (H, W, 3) uint8 RGB array."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, body = 16, 0, img.astype(">u2")
    elif img.dtype == np.uint8 and img.ndim in (2, 3):
        depth, ctype, body = 8, (0 if img.ndim == 2 else 2), img
        if img.ndim == 3 and img.shape[2] != 3:
            raise ValueError("encode_png: an 8-bit color image must be RGB")
    else:
        raise ValueError(f"encode_png: unsupported array {img.dtype} {img.shape}")
    raw = b"".join(b"\x00" + np.ascontiguousarray(body[y]).tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return _PNG_SIG + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")


def read_image_gray(path) -> np.ndarray:
    """(H, W) float32 gray; RGB is weighted in float64 and then cast, as the
    reference does."""
    img = read_png(path)
    if img.ndim == 3:
        img = img @ np.array([0.299, 0.587, 0.114])
    return img.astype(np.float32)


def read_depth_tum(path, factor: float = 5000.0) -> np.ndarray:
    """(H, W) float32 depth in metres from a 16-bit TUM depth PNG."""
    return read_png(path).astype(np.float32) / factor


def write_tum_rgbd(root: str | Path, images, depths, Tcw) -> dict:
    """Write frames as a TUM RGB-D directory: gray images (n, H, W) as RGB
    PNGs (three equal channels, rounded to uint8), depths (n, H, W) in
    metres as 16-bit PNGs at x5000 (TUM's DepthMapFactor), and the ground
    truth Twc of each world->camera pose in `Tcw` as `groundtruth.txt` (tx ty
    tz qx qy qz qw). Frame i is stamped i * 0.1 s and its depth 4 ms later,
    so the loader's association has to pair them. Returns {t: Twc} as
    written."""
    root = Path(root)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    rgb_lines, depth_lines, gt_lines, gt = [], [], [], {}
    for i, (img, dep, T) in enumerate(zip(images, depths, Tcw)):
        t = i * 0.1
        g = np.clip(np.round(np.asarray(img, np.float64)), 0, 255).astype(np.uint8)
        (root / "rgb" / f"{i:05d}.png").write_bytes(encode_png(np.repeat(g[:, :, None], 3, axis=2)))
        d = np.clip(np.round(np.asarray(dep, np.float64) * 5000.0), 0, 65535).astype(np.uint16)
        (root / "depth" / f"{i:05d}.png").write_bytes(encode_png(d))
        rgb_lines.append(f"{t:.6f} rgb/{i:05d}.png")
        depth_lines.append(f"{t + 0.004:.6f} depth/{i:05d}.png")
        Twc = np.linalg.inv(np.asarray(T, np.float64))
        q = lie.rot_to_quat(torch.from_numpy(Twc[:3, :3])).numpy()
        gt_lines.append(f"{t:.6f} " + " ".join(f"{v:.9f}" for v in (*Twc[:3, 3], *q)))
        gt[round(t, 6)] = Twc
    header = "# timestamp filename\n"
    (root / "rgb.txt").write_text(header + "\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text(header + "\n".join(depth_lines) + "\n")
    (root / "groundtruth.txt").write_text("# timestamp tx ty tz qx qy qz qw\n" + "\n".join(gt_lines) + "\n")
    return gt


# ---------------------------------------------------------------------------
# EuRoC
# ---------------------------------------------------------------------------

# EuRoC cam0 body->sensor extrinsic (x_body = T_BS @ x_cam0), the value every
# EuRoC MAV dataset ships in mav0/cam0/sensor.yaml. The ground truth stores
# T_WB; camera poses are T_WB @ T_BS.
EUROC_CAM0_T_BS = np.array(
    [
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


def _read_euroc_t_bs(sensor_yaml: Path) -> np.ndarray | None:
    """The T_BS 4x4 of a EuRoC sensor.yaml (`data: [a, b, ...]` after
    `T_BS:`), or None when the file or the entry is missing."""
    try:
        text = sensor_yaml.read_text()
    except OSError:
        return None
    m = re.search(r"T_BS:.*?data:\s*\[([^\]]+)\]", text, re.DOTALL)
    if not m:
        return None
    vals = [float(x) for x in m.group(1).replace("\n", " ").split(",")]
    if len(vals) != 16:
        return None
    return np.array(vals).reshape(4, 4)


def load_euroc_stereo(root: str | Path, max_dt: float = 0.005):
    """A EuRoC ASL directory (mav0/cam0, mav0/cam1,
    mav0/state_groundtruth_estimate0). Returns (pairs [{t, left, right}],
    gt {t: Twc of cam0}): cam0 and cam1 paired by timestamp; the ground
    truth's T_WB composed with cam0's T_BS (from its sensor.yaml, else the
    factory value)."""
    root = Path(root)

    def read_cam(cam):
        rows = []
        for line in (root / "mav0" / cam / "data.csv").read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts_ns, fname = line.split(",")[:2]
            rows.append((int(ts_ns) * 1e-9, root / "mav0" / cam / "data" / fname.strip()))
        return rows

    cam0 = read_cam("cam0")
    cam1 = read_cam("cam1")
    t1 = np.array([t for t, _ in cam1])
    pairs = []
    for t, left in cam0:
        j = int(np.argmin(np.abs(t1 - t)))
        if abs(t1[j] - t) <= max_dt:
            pairs.append({"t": t, "left": left, "right": cam1[j][1]})

    gt = {}
    gt_csv = root / "mav0" / "state_groundtruth_estimate0" / "data.csv"
    if gt_csv.exists():
        T_BS = _read_euroc_t_bs(root / "mav0" / "cam0" / "sensor.yaml")
        if T_BS is None:
            T_BS = EUROC_CAM0_T_BS
        for line in gt_csv.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split(",")
            qw, qx, qy, qz = float(v[4]), float(v[5]), float(v[6]), float(v[7])
            T_WB = _quat_pose([float(v[1]), float(v[2]), float(v[3])], [qx, qy, qz, qw])
            gt[int(v[0]) * 1e-9] = T_WB @ T_BS
    return pairs, gt


# EuRoC factory stereo calibration (LEFT/RIGHT K and D, and the cam0->cam1
# extrinsics), for a StereoRectifier on raw ASL data.
EUROC_CALIB = {
    "K1": [[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]],
    "D1": [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0],
    "K2": [[457.587, 0.0, 379.999], [0.0, 456.134, 255.238], [0.0, 0.0, 1.0]],
    "D2": [-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05, 0.0],
    # x_cam1 = R @ x_cam0 + T
    "R": [
        [0.999997256, 0.002312067, 0.000376008],
        [-0.002317135, 0.999898049, 0.014089836],
        [-0.000343393, -0.014090668, 0.999900663],
    ],
    "T": [-0.110073808, 0.000399121, -0.000853703],
    "size": (752, 480),
}


# ---------------------------------------------------------------------------
# KITTI
# ---------------------------------------------------------------------------


def load_kitti_stereo(root: str | Path, sequence: str = "00"):
    """KITTI odometry: (pairs [{t, left, right}], gt {t: Twc}) from
    sequences/<seq>/image_0, image_1, times.txt and poses/<seq>.txt."""
    root = Path(root)
    seq = root / "sequences" / sequence
    lefts = sorted((seq / "image_0").glob("*.png"))
    rights = sorted((seq / "image_1").glob("*.png"))
    times = [float(x) for x in (seq / "times.txt").read_text().split()]
    gt = {}
    pose_file = root / "poses" / f"{sequence}.txt"
    if pose_file.exists():
        for i, line in enumerate(pose_file.read_text().splitlines()):
            Twc = np.eye(4)
            Twc[:3] = np.array(line.split(), np.float64).reshape(3, 4)
            gt[times[i]] = Twc
    pairs = [{"t": t, "left": l, "right": r} for t, l, r in zip(times, lefts, rights)]
    return pairs, gt
