"""Hand-written CUDA kernels for Hopper: build, load, launch.

The sources live in `csrc/`. Each is compiled with nvcc for `sm_90a` into a
shared library of its own with a plain C interface, loaded with ctypes. The
build happens at first use, one nvcc per source and all started together,
into `build/torch_kernels/` at the repository root, under names keyed on the
sources' content, so a changed source rebuilds and an unchanged one loads at
once. Importing this module looks for no compiler.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch, launches on PyTorch's current stream, raises if the C
entry point returns a CUDA error, and adds one to its kernel's launch count.
The wrappers accept CUDA tensors only; the device dispatch (kernel on the
card, plain PyTorch on the CPU) lives in `ops/fast.py` and `ops/matching.py`.

| kernel | source | replaces (TPU) | form: wrapper | plain version |
| --- | --- | --- | --- | --- |
| fast_score_nms | csrc/fast_score_nms.cu | ops/pallas_kernels.py fast_score_nms | score map of one level: `fast_score_nms` | ops/fast.py nms3(fast_score(.)) |
| | | | best corner per 16x16 cell, whole pyramid in one launch: `fast_cells_pyramid` | ops/fast.py rank_cells(nms3(fast_score(.))) per level |
| masked_best_two | csrc/masked_best_two.cu | ops/pallas_kernels.py masked_best_two | (argmin, best, second): `masked_best_two` | ops/matching.py masked_best_two_plain |
| | | | finished one-to-one match: `masked_match` | ops/matching.py match_projection_plain |

`csrc/launch_floor.cu` holds an empty kernel (`empty_launch`) that only the
timing scripts launch: the device-side cost of a launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
SOURCES = ("fast_score_nms.cu", "masked_best_two.cu", "launch_floor.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Fixed by the kernels: the cell size and level count of fast_score_nms's cell
# form and the "no candidate" distance of masked_best_two.
FAST_CELL = 16
FAST_MAX_LEVELS = 16
SEARCH_NO_CANDIDATE = 1 << 20

# Launches per kernel since the last reset_launch_counts(); a wrapper adds
# one exactly where it launches its kernel.
LAUNCHES = {"fast_score_nms": 0, "masked_best_two": 0}

_libs: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> float:
    """Compile every source whose content-keyed library is missing, one nvcc
    per source, all started together; returns the seconds spent (0.0 when
    everything was already built)."""
    todo = [s for s in SOURCES if not library_path(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp, str(CSRC / src)]
        procs.append((src, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {src} ({proc.returncode}):\n{out}")
            continue
        if verbose:
            print(out, flush=True)
        os.replace(tmp, library_path(src))
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def _load(source: str):
    lib = _libs.get(source)
    if lib is None:
        build()
        lib = _libs[source] = ctypes.CDLL(str(library_path(source)))
        _declare(source, lib)
    return lib


def _declare(source: str, lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    F = ctypes.c_float
    if source == "fast_score_nms.cu":
        lib.fast_score_nms.argtypes = [P, P, I, I, P]
        lib.fast_score_nms.restype = I
        lib.fast_score_nms_cells.argtypes = [P, P, P, I, F, F, I, I, P, P, P]
        lib.fast_score_nms_cells.restype = I
    elif source == "masked_best_two.cu":
        search = [P] * 9 + [I] * 5  # inputs, then B, Q, N, level_lo, level_hi
        lib.masked_best_two.argtypes = search + [P, P, P, P]
        lib.masked_best_two.restype = I
        lib.masked_match.argtypes = search + [I, F, P, P, P, P, P]
        lib.masked_match.restype = I
    elif source == "launch_floor.cu":
        lib.empty_launch.argtypes = [P]
        lib.empty_launch.restype = I


def empty_launch(device=None) -> None:
    """Launch the empty kernel of `csrc/launch_floor.cu` on the current
    stream: the device-side floor of a launch, for the timing scripts."""
    rc = _load("launch_floor.cu").empty_launch(_stream(device))
    if rc != 0:
        raise RuntimeError(f"empty_launch failed: CUDA error {rc}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fast_score_nms(img: torch.Tensor) -> torch.Tensor:
    """Kernel 1, map form: FAST-9/16 score + 3x3 NMS of one level, (H, W)
    float32 CUDA -> (H, W) float32; equals
    `ops.fast.nms3(ops.fast.fast_score(img))`."""
    if img.dim() != 2:
        raise ValueError(f"img: expected (H, W), got {tuple(img.shape)}")
    _check("img", img, torch.float32, img.shape, img.device)
    lib = _load("fast_score_nms.cu")
    out = torch.empty_like(img)
    h, w = img.shape
    rc = lib.fast_score_nms(img.data_ptr(), out.data_ptr(), h, w, _stream(img.device))
    if rc != 0:
        raise RuntimeError(f"fast_score_nms launch failed: CUDA error {rc}")
    LAUNCHES["fast_score_nms"] += 1
    return out


def fast_cells_pyramid(levels, cell: int, border: int, threshold: float, min_threshold: float,
                       min_stride: int = 0):
    """Kernel 1, cell form: all levels of a pyramid in one launch. `levels`
    is a sequence of (H, W) float32 CUDA tensors. Returns (cell_best (L, S)
    float32, cell_arg (L, S) int64, grids): row l holds the ch x cw cells of
    level l in row-major order, `rank_cells(nms3(fast_score(level)), ...)`
    flattened; S = max(largest level, min_stride), cell_best is zero past a
    level's cells and cell_arg is undefined there; grids[l] = (ch, cw). The
    score map is not written."""
    if cell != FAST_CELL:
        raise ValueError(f"cell: the kernel reduces {FAST_CELL}x{FAST_CELL} cells, got {cell}")
    if not 0 < len(levels) <= FAST_MAX_LEVELS:
        raise ValueError(f"levels: expected 1..{FAST_MAX_LEVELS} levels, got {len(levels)}")
    if border < 0:
        raise ValueError(f"border: expected >= 0, got {border}")
    dev = levels[0].device
    for i, lvl in enumerate(levels):
        if lvl.dim() != 2 or lvl.numel() == 0:
            raise ValueError(f"levels[{i}]: expected a non-empty (H, W), got {tuple(lvl.shape)}")
        _check(f"levels[{i}]", lvl, torch.float32, lvl.shape, dev)
    lib = _load("fast_score_nms.cu")
    n = len(levels)
    grids = [(-(-lvl.shape[0] // cell), -(-lvl.shape[1] // cell)) for lvl in levels]
    stride = max(max(ch * cw for ch, cw in grids), int(min_stride))
    best = torch.zeros((n, stride), dtype=torch.float32, device=dev)  # zeros past a level's cells
    arg = torch.empty((n, stride), dtype=torch.int64, device=dev)  # never read there
    rc = lib.fast_score_nms_cells(
        (ctypes.c_void_p * n)(*(lvl.data_ptr() for lvl in levels)),
        (ctypes.c_int * n)(*(lvl.shape[0] for lvl in levels)),
        (ctypes.c_int * n)(*(lvl.shape[1] for lvl in levels)),
        n, float(threshold), float(min_threshold), int(border), stride,
        best.data_ptr(), arg.data_ptr(), _stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"fast_score_nms (cell form) launch failed: CUDA error {rc}")
    LAUNCHES["fast_score_nms"] += 1
    return best, arg, grids


def _check_search(q_words, q_xy, q_level, q_valid, radius, t_words, t_xy, t_level, t_valid):
    if q_words.dim() != 3 or t_words.dim() != 3:
        raise ValueError("q_words, t_words: expected (B, Q, 8) and (B, N, 8)")
    B, Q, N = q_words.shape[0], q_words.shape[1], t_words.shape[1]
    dev = q_words.device
    _check("q_words", q_words, torch.int32, (B, Q, 8), dev)
    _check("q_xy", q_xy, torch.float32, (B, Q, 2), dev)
    _check("q_level", q_level, torch.int32, (B, Q), dev)
    _check("q_valid", q_valid, torch.bool, (B, Q), dev)
    _check("radius", radius, torch.float32, (B, Q), dev)
    _check("t_words", t_words, torch.int32, (B, N, 8), dev)
    _check("t_xy", t_xy, torch.float32, (B, N, 2), dev)
    _check("t_level", t_level, torch.int32, (B, N), dev)
    _check("t_valid", t_valid, torch.bool, (B, N), dev)
    for name, t, align in (("q_words", q_words, 16), ("t_words", t_words, 16), ("t_xy", t_xy, 8)):
        if t.data_ptr() % align:
            raise ValueError(f"{name}: data must be {align}-byte aligned")
    return B, Q, N, dev


def masked_best_two(q_words, q_xy, q_level, q_valid, radius,
                    t_words, t_xy, t_level, t_valid, level_lo: int, level_hi: int):
    """Kernel 2, best-two form: batched masked Hamming search on CUDA tensors.

    q_words (B, Q, 8) int32, q_xy (B, Q, 2) float32, q_level (B, Q) int32,
    q_valid (B, Q) bool, radius (B, Q) float32; t_words (B, N, 8) int32,
    t_xy (B, N, 2) float32, t_level (B, N) int32, t_valid (B, N) bool.
    Returns (best_idx int64, best int32, second int32), each (B, Q); equals
    `ops.matching.masked_best_two_plain`."""
    args = (q_words, q_xy, q_level, q_valid, radius, t_words, t_xy, t_level, t_valid)
    B, Q, N, dev = _check_search(*args)
    lib = _load("masked_best_two.cu")
    idx = torch.empty((B, Q), dtype=torch.int64, device=dev)
    best = torch.empty((B, Q), dtype=torch.int32, device=dev)
    second = torch.empty_like(best)
    rc = lib.masked_best_two(
        *(t.data_ptr() for t in args), B, Q, N, int(level_lo), int(level_hi),
        idx.data_ptr(), best.data_ptr(), second.data_ptr(), _stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"masked_best_two launch failed: CUDA error {rc}")
    LAUNCHES["masked_best_two"] += 1
    return idx, best, second


def masked_match(q_words, q_xy, q_level, q_valid, radius, t_words, t_xy, t_level, t_valid,
                 level_lo: int, level_hi: int, max_dist: int, nn_ratio: float):
    """Kernel 2, match form: the search of `masked_best_two`, then
    `best <= max_dist`, the float32 ratio test and the one-to-one resolution
    (per target the best distance wins, ties to the first query), on the
    same inputs. Returns (idx int64, dist int32, ok bool), each (B, Q); equals
    `ops.matching.match_projection_plain`."""
    args = (q_words, q_xy, q_level, q_valid, radius, t_words, t_xy, t_level, t_valid)
    B, Q, N, dev = _check_search(*args)
    if not 0 <= int(max_dist) < SEARCH_NO_CANDIDATE:
        raise ValueError(f"max_dist: expected 0..{SEARCH_NO_CANDIDATE - 1}, got {max_dist}")
    lib = _load("masked_best_two.cu")
    # idx and the per-target owner words (8 bytes each) share one buffer.
    words = torch.empty(B * (Q + N), dtype=torch.int64, device=dev)
    idx, owner = words[:B * Q].view(B, Q), words[B * Q:]
    owner.fill_(-1)  # all ones: no query holds the target yet
    dist = torch.empty((B, Q), dtype=torch.int32, device=dev)
    ok = torch.empty((B, Q), dtype=torch.bool, device=dev)
    rc = lib.masked_match(
        *(t.data_ptr() for t in args), B, Q, N, int(level_lo), int(level_hi),
        int(max_dist), float(nn_ratio), idx.data_ptr(), dist.data_ptr(), ok.data_ptr(),
        owner.data_ptr(), _stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"masked_best_two (match form) launch failed: CUDA error {rc}")
    LAUNCHES["masked_best_two"] += 1
    return idx, dist, ok
