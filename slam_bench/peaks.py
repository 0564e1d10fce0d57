"""The card's published peaks and the work of the program's kernels.

NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit: 67
TFLOP/s in float32 outside the tensor cores (a multiply-add counted as
two), 3.35 TB/s of HBM3. A card set below 700 W runs slower under load, so
every share of these peaks is printed beside the card's power limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# Float32 operations that are not multiply-adds: half of 67 TFLOP/s.
F32_OPS_PER_S = 33.5e12

# fast_score_nms, cell form (csrc/fast_score_nms.cu): per pyramid pixel 16
# subtractions, 64 mins and 64 maxes for the circular 9-windows in doubling
# form, 32 to reduce them and 9 for the 3x3 suppression.
FAST_OPS_PER_PIXEL = 185


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    out = []
    for l in range(n_levels):
        s = 1.0 / (scale**l)
        out.append((int(round(h * s)), int(round(w * s))))
    return out


def fast_cells_work(h: int, w: int, n_levels: int, scale: float, cell: int = 16) -> tuple[float, float]:
    """(operations, bytes) of one cell-form launch over a frame's pyramid:
    each pixel read once (4 bytes), each 16x16 cell's best rank and index
    written once (12 bytes)."""
    shapes = pyramid_shapes(h, w, n_levels, scale)
    pixels = sum(a * b for a, b in shapes)
    cells = sum(-(-a // cell) * -(-b // cell) for a, b in shapes)
    return FAST_OPS_PER_PIXEL * pixels, 4.0 * pixels + 12.0 * cells


def least_seconds(ops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / F32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)
