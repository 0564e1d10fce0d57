"""Hamming distance over packed 256-bit ORB descriptors.

Port of the JAX package's `ops/hamming.py`. Descriptor layout: the reference
packs a descriptor as (.., 8) uint32; PyTorch has no right shift for uint32 on
the CPU, so the port keeps the same bit pattern in (.., 8) int32 words — bit
`b` of word `w` is descriptor bit `32*w + b`. `words_from_uint32` /
`words_to_uint32` convert between the two layouts without touching a bit.

* `distance_packed` — XOR + popcount, exact.
* `distance_matrix` — all pairs as one float32 product of +-1 descriptors:
  dot(a, b) = 256 - 2*hamming, exact in float32 (integers <= 256; TF32 is
  off package-wide).
"""

from __future__ import annotations

import numpy as np
import torch


def words_from_uint32(packed: np.ndarray) -> np.ndarray:
    """(.., 8) uint32 -> (.., 8) int32 with the same bits (a view cast)."""
    return np.ascontiguousarray(packed, dtype=np.uint32).view(np.int32)


def words_to_uint32(words: torch.Tensor) -> np.ndarray:
    """(.., 8) int32 tensor -> (.., 8) uint32 numpy array with the same bits."""
    return np.ascontiguousarray(words.detach().cpu().numpy(), dtype=np.int32).view(np.uint32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of the 32 bits of an int32 tensor (SWAR bit-hack
    on the zero-extended int64 value, so no step can overflow)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def distance_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between packed descriptors, broadcasting.

    a, b: (..., 8) int32 words -> (...,) int32 in [0, 256].
    """
    return torch.sum(popcount32(torch.bitwise_xor(a, b)), dim=-1, dtype=torch.int32)


def distance_matrix(a_pm1: torch.Tensor, b_pm1: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming from +-1 descriptors: (..., Q, 256), (..., N, 256)
    -> (..., Q, N) int32."""
    dots = a_pm1.float() @ b_pm1.float().transpose(-1, -2)
    return ((256.0 - dots) * 0.5).to(torch.int32)


def unpack_pm1(words: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 256) float32 +-1."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1  # arithmetic shift: & 1 keeps bit b
    return bits.reshape(*words.shape[:-1], 256).to(torch.float32) * 2 - 1


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 words (bit b of word w = bit 32w+b)."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = torch.sum(bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64) << shifts, dim=-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)
