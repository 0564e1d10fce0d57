"""Offline visualization: the Viewer / FrameDrawer / MapDrawer analog.

Port of the JAX package's `utils/viz.py`. The reference renders live
Pangolin/HighGUI windows (src/FrameDrawer.cc:41-168, src/MapDrawer.cc:58-260);
here frames and maps are drawn into uint8 arrays and written as PNG with a
stdlib-zlib encoder:

* `draw_frame`  — the camera image with tracked (green) and untracked (blue)
                  features and a status bar (FrameDrawer::DrawFrame);
* `draw_map`    — an orthographic top-down view of map points, keyframes,
                  covisibility edges and the current camera (MapDrawer);
* `write_png`   — a minimal RGB PNG writer;
* `FrameRecorder` — dumps frame and map PNGs every few frames.

Device tensors (a map, a frame) are read to the host in one counted
transfer each (`sync.host_numpy`); the drawing is the reference's numpy code.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .. import sync

# ---------------------------------------------------------------------------
# PNG writer
# ---------------------------------------------------------------------------


def write_png(path, rgb: np.ndarray):
    """Write an (H, W, 3) uint8 array as PNG."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


# ---------------------------------------------------------------------------
# Tiny 5x7 bitmap font (status bar text; FrameDrawer::DrawTextInfo analog)
# ---------------------------------------------------------------------------

_FONT = {
    "0": "01110100011001110101110011000101110",
    "1": "00100011000010000100001000010001110",
    "2": "01110100010000100110010001000011111",
    "3": "01110100010000101110000011000101110",
    "4": "00010001100101010010111110001000010",
    "5": "11111100001111000001000011000101110",
    "6": "01110100001000011110100011000101110",
    "7": "11111000010001000100010001000010000",
    "8": "01110100011000101110100011000101110",
    "9": "01110100011000101111000010000101110",
    "K": "10001100101010011000101001001010001",
    "F": "11111100001000011110100001000010000",
    "M": "10001110111010110001100011000110001",
    "P": "11110100011000111110100001000010000",
    "O": "01110100011000110001100011000101110",
    "L": "10000100001000010000100001000011111",
    "S": "01111100001000001110000010000111110",
    "T": "11111001000010000100001000010000100",
    "I": "01110001000010000100001000010001110",
    "N": "10001110011010110011100011000110001",
    "E": "11111100001000011110100001000011111",
    "R": "11110100011000111110101001001010001",
    "A": "01110100011000111111100011000110001",
    "C": "01110100011000010000100001000101110",
    "D": "11110100011000110001100011000111110",
    "G": "01111100001000010111100011000101111",
    ":": "00000001000000000000000000100000000",
    "=": "00000000001111100000111110000000000",
    " ": "00000000000000000000000000000000000",
    ".": "00000000000000000000000000100001100",
    "/": "00001000010001000100010001000010000",
    "-": "00000000000000011111000000000000000",
}


def draw_text(img: np.ndarray, x: int, y: int, text: str,
              color=(255, 255, 255), scale: int = 1):
    """Blit text at (x, y) top-left. Unknown chars are skipped."""
    h, w = img.shape[:2]
    cx = x
    for ch in text.upper():
        bits = _FONT.get(ch)
        if bits is None:
            cx += 6 * scale
            continue
        for r in range(7):
            for c in range(5):
                if bits[r * 5 + c] == "1":
                    y0, x0 = y + r * scale, cx + c * scale
                    img[max(0, y0):min(h, y0 + scale),
                        max(0, x0):min(w, x0 + scale)] = color
        cx += 6 * scale
    return img


# ---------------------------------------------------------------------------
# Drawing primitives on uint8 canvases
# ---------------------------------------------------------------------------


def _square(img, x, y, r, color):
    h, w = img.shape[:2]
    x, y = int(x), int(y)
    x0, x1 = max(0, x - r), min(w, x + r + 1)
    y0, y1 = max(0, y - r), min(h, y + r + 1)
    if x0 >= x1 or y0 >= y1:
        return
    img[y0:y1, x0] = color
    img[y0:y1, x1 - 1] = color
    img[y0, x0:x1] = color
    img[y1 - 1, x0:x1] = color


def _line(img, x0, y0, x1, y1, color):
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.linspace(x0, x1, n + 1).astype(int)
    ys = np.linspace(y0, y1, n + 1).astype(int)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


# ---------------------------------------------------------------------------
# FrameDrawer analog
# ---------------------------------------------------------------------------


def draw_frame(gray, xy, tracked_mask, kp_valid, state_text: str = "",
               n_kf: int = 0, n_mp: int = 0) -> np.ndarray:
    """Render the FrameDrawer overlay: green squares on map-tracked features,
    blue on extracted-but-unmatched, plus the status bar
    (src/FrameDrawer.cc:84-130 draws exactly these two classes)."""
    gray = np.asarray(gray)
    img = np.repeat(
        np.clip(gray, 0, 255).astype(np.uint8)[:, :, None], 3, axis=2
    ).copy()
    xy = np.asarray(xy)
    tracked = np.asarray(tracked_mask) & np.asarray(kp_valid)
    untracked = ~np.asarray(tracked_mask) & np.asarray(kp_valid)
    for x, y in xy[untracked]:
        _square(img, x, y, 2, (80, 120, 255))
    for x, y in xy[tracked]:
        _square(img, x, y, 3, (0, 255, 0))
    bar = np.zeros((14, img.shape[1], 3), np.uint8)
    text = f"{state_text}  KF:{n_kf} MP:{n_mp} TRACKED:{int(tracked.sum())}"
    draw_text(bar, 4, 3, text)
    return np.concatenate([img, bar], axis=0)


# ---------------------------------------------------------------------------
# MapDrawer analog
# ---------------------------------------------------------------------------


def draw_map(state, size: int = 720, axes=(0, 2), cur_pose=None,
             draw_graph: bool = True, min_weight: int = 15) -> np.ndarray:
    """Orthographic projection of the map onto two world axes (default X-Z,
    the reference viewer's follow plane): map points (white), keyframes (blue
    frusta origin markers), covisibility edges (green), current camera (red)
    — MapDrawer::DrawMapPoints/DrawKeyFrames (src/MapDrawer.cc:58-260)."""
    from ..models.map_state import covisibility
    from ..ops.lie import se3_inverse

    img = np.zeros((size, size, 3), np.uint8)
    mp_pos, mp_valid, kf_valid_all, kf_pose, n_kf, covis = sync.host_numpy(
        state.mp_pos, state.mp_valid, state.kf_valid, state.kf_pose, state.n_kf, covisibility(state))
    mp = mp_pos[mp_valid]
    n_kf = int(n_kf)
    kf_valid = kf_valid_all[:n_kf]
    rot = kf_pose[:n_kf, :3, :3]
    centers = (np.einsum("kij->kji", rot) @ (-kf_pose[:n_kf, :3, 3:]))[:, :, 0]

    pts = [mp[:, list(axes)]] if len(mp) else []
    if n_kf:
        pts.append(centers[kf_valid][:, list(axes)])
    if not pts:
        return img
    allp = np.concatenate(pts, 0)
    lo, hi = allp.min(0), allp.max(0)
    span = max(float((hi - lo).max()), 1e-3) * 1.15
    mid = (lo + hi) / 2

    def to_px(p):
        q = (p[..., :2] - mid) / span * size + size / 2
        return q[..., 0], size - 1 - q[..., 1]

    if len(mp):
        xs, ys = to_px(mp[:, list(axes)])
        ok = (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
        img[ys[ok].astype(int), xs[ok].astype(int)] = (200, 200, 200)

    if n_kf and draw_graph:
        C = covis[:n_kf, :n_kf]
        ii, jj = np.where(np.triu(C, 1) >= min_weight)
        for i, j in zip(ii, jj):
            if kf_valid[i] and kf_valid[j]:
                x0, y0 = to_px(centers[i][list(axes)])
                x1, y1 = to_px(centers[j][list(axes)])
                _line(img, x0, y0, x1, y1, (0, 160, 0))

    for k in range(n_kf):
        if kf_valid[k]:
            x, y = to_px(centers[k][list(axes)])
            _square(img, x, y, 3, (80, 160, 255))

    if cur_pose is not None:
        (Twc,) = sync.host_numpy(se3_inverse(torch.as_tensor(cur_pose, dtype=torch.float32)))
        x, y = to_px(Twc[:3, 3][list(axes)])
        _square(img, x, y, 5, (255, 60, 60))
        # heading tick along camera +z
        z = Twc[:3, 2][list(axes)]
        nz = np.linalg.norm(z) + 1e-9
        x1 = x + z[0] / nz * 12
        y1 = y - z[1] / nz * 12
        _line(img, x, y, x1, y1, (255, 60, 60))

    draw_text(img, 6, 6, f"KF:{int(kf_valid.sum())} MP:{len(mp)}")
    return img


class FrameRecorder:
    """Viewer-thread analog: dump frame/map PNGs every N frames for offline
    playback (the Pangolin window replacement)."""

    def __init__(self, out_dir, every: int = 5, map_every: int = 15):
        from pathlib import Path

        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every = every
        self.map_every = map_every
        self.n = 0

    def record(self, gray, frame, state, state_text=""):
        if self.n % self.every == 0:
            if isinstance(gray, torch.Tensor):
                (gray,) = sync.host_numpy(gray)
            xy, mp, kp_valid, kf_valid, mp_valid = sync.host_numpy(
                frame.xy, frame.mp, frame.kp_valid, state.kf_valid, state.mp_valid)
            img = draw_frame(gray, xy, mp >= 0, kp_valid, state_text,
                             n_kf=int(kf_valid.sum()), n_mp=int(mp_valid.sum()))
            write_png(self.dir / f"frame_{self.n:05d}.png", img)
        if self.n % self.map_every == 0:
            write_png(self.dir / f"map_{self.n:05d}.png", draw_map(state, cur_pose=frame.pose))
        self.n += 1
