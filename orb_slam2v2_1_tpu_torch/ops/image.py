"""Image pyramid + Gaussian kernel.

Port of the JAX package's `ops/image.py` (`pyramid_shapes`, `build_pyramid`,
`_gauss_kernel`), and `gather_windows`, the batched `lax.dynamic_slice` that
ORB patches and the stereo SAD windows are cut with. Every level is resized from the base image, as in the
reference. The reference resizes with `jax.image.resize(..., "bilinear")`,
which for a downscale is an antialiased triangle filter whose width grows
with the scale factor; the port builds the same separable weight matrices
(`_resize_weights`, the formula of jax's `compute_weight_mat`) and applies
them as two float32 matrix products, so a level differs from the
reference's only by float32 summation order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    """Static per-level shapes (Python ints, computed once)."""
    shapes = []
    for lvl in range(n_levels):
        s = 1.0 / (scale**lvl)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return shapes


def _resize_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 antialiased triangle-filter resize weights."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, 1),
        0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_weights_np(n_in, n_out)).to(device)


def build_pyramid(img: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    """float32 image (H, W) -> list of n_levels images, each 1/scale smaller."""
    h, w = img.shape
    out = [img]
    for (lh, lw) in pyramid_shapes(h, w, n_levels, scale)[1:]:
        wy = _resize_weights(h, lh, img.device)
        wx = _resize_weights(w, lw, img.device)
        out.append(wy.T @ img @ wx)
    return out


def _gauss_kernel(size: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gather_windows(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(K, h, w) windows of img (H, W) at start rows y0 and columns x0 (K,),
    as `lax.dynamic_slice` cuts them: a negative start counts from the end,
    then the start is clamped so the whole window fits. A window larger than
    the image raises TypeError, as `lax.dynamic_slice` does."""
    H, W = img.shape
    if h > H or w > W:
        raise TypeError(f"gather_windows: a {h}x{w} window is larger than the {H}x{W} image")

    def start(s, size, n):
        s = s.long()
        return torch.clamp(torch.where(s < 0, s + n, s), 0, n - size)

    rows = (start(y0, h, H)[:, None] + torch.arange(h, device=img.device))[:, :, None]
    cols = (start(x0, w, W)[:, None] + torch.arange(w, device=img.device))[:, None, :]
    return img[rows, cols]
