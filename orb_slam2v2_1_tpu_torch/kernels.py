"""Hand-written CUDA kernels for Hopper: build, load, launch.

The sources live in `csrc/`. They are compiled with nvcc for `sm_90a` into
one shared library with a plain C interface, loaded with ctypes. The build
happens at first use, into `build/torch_kernels/` at the repository root,
under a name keyed on the sources' content, so a changed source rebuilds and
an unchanged one loads at once. Importing this module looks for no compiler.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on PyTorch's current stream, raises if the C entry point
returns a CUDA error, and adds one to its launch count. The wrappers accept
CUDA tensors only; the device dispatch (kernel on the card, plain PyTorch on
the CPU) lives in `ops/fast.suppressed_score` and
`ops/matching.masked_best_two`.

| kernel | source | replaces (TPU) | plain twin |
| --- | --- | --- | --- |
| fast_score_nms | csrc/fast_score_nms.cu | ops/pallas_kernels.py fast_score_nms | ops/fast.py nms3(fast_score(.)) |
| masked_best_two | csrc/masked_best_two.cu | ops/pallas_kernels.py masked_best_two | ops/matching.py masked_best_two_plain |
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
SOURCES = ("fast_score_nms.cu", "masked_best_two.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Launches per kernel since the last reset_launch_counts(); a wrapper adds
# one exactly where it launches its kernel.
LAUNCHES = {"fast_score_nms": 0, "masked_best_two": 0}

_lib = None


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


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"liborb_torch_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> float:
    """Compile the kernels if the content-keyed library is missing; returns
    the seconds spent (0.0 when it was already built)."""
    path = library_path()
    if path.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, path)
    return time.perf_counter() - t0


def _load():
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(str(library_path()))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fast_score_nms.argtypes = [P, P, I, I, P]
    lib.fast_score_nms.restype = I
    lib.masked_best_two.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P, P, P, P]
    lib.masked_best_two.restype = I
    _lib = lib
    return lib


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
    """Kernel 1: FAST-9/16 score + 3x3 NMS of one level, (H, W) float32 CUDA
    -> (H, W) float32; equals `ops.fast.nms3(ops.fast.fast_score(img))`."""
    if img.dim() != 2:
        raise ValueError(f"img: expected (H, W), got {tuple(img.shape)}")
    _check("img", img, torch.float32, img.shape, img.device)
    lib = _load()
    out = torch.empty_like(img)
    h, w = img.shape
    rc = lib.fast_score_nms(img.data_ptr(), out.data_ptr(), h, w, _stream(img.device))
    if rc != 0:
        raise RuntimeError(f"fast_score_nms launch failed: CUDA error {rc}")
    LAUNCHES["fast_score_nms"] += 1
    return out


def masked_best_two(q_words, q_xy, q_level, q_valid, radius,
                    t_words, t_xy, t_level, t_valid, level_lo: int, level_hi: int):
    """Kernel 2: batched fused masked Hamming search on CUDA tensors.

    q_words (B, Q, 8) int32, q_xy (B, Q, 2) float32, q_level (B, Q) int32,
    q_valid (B, Q) bool, radius (B, Q) float32; t_words (B, N, 8) int32,
    t_xy (B, N, 2) float32, t_level (B, N) int32, t_valid (B, N) bool.
    Returns (best_idx, best, second), each (B, Q) int32; equals
    `ops.matching.masked_best_two_plain`."""
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
    for name, t in (("q_words", q_words), ("t_words", t_words)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    lib = _load()
    idx = torch.empty((B, Q), dtype=torch.int32, device=dev)
    best = torch.empty_like(idx)
    second = torch.empty_like(idx)
    rc = lib.masked_best_two(
        q_words.data_ptr(), q_xy.data_ptr(), q_level.data_ptr(), q_valid.data_ptr(),
        radius.data_ptr(), t_words.data_ptr(), t_xy.data_ptr(), t_level.data_ptr(),
        t_valid.data_ptr(), B, Q, N, int(level_lo), int(level_hi),
        idx.data_ptr(), best.data_ptr(), second.data_ptr(), _stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"masked_best_two launch failed: CUDA error {rc}")
    LAUNCHES["masked_best_two"] += 1
    return idx, best, second
