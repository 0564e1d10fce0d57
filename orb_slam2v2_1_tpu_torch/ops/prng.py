"""The part of `jax.random` that the RANSAC samplers use, bit for bit.

The JAX package draws every RANSAC hypothesis set from a `jax.random` key by
Gumbel top-k. Its generator is Threefry-2x32 (Salmon et al., SC 2011), a
counter-based function of integers, so the port computes the same stream: a
key is the pair of 32-bit words that `jax.random.key_data` gives, `split` and
`fold_in` hash small counters under it, and `bits32` hashes the flat
row-major index of every element of its output, in the layout that
`jax_threefry_partitionable` selects (JAX's default since 0.5).

The Gumbel noise -log(-log u) itself is not recomputed: float32 logs round
differently from XLA's in about a quarter of the entries. It does not need to
be. u is the 23-bit integer `bits32 >> 9` over 2**23, and -log(-log u)
increases with u, so ranking those integers picks the reference's top k,
ties (lower index first) and invalid entries (last, in index order)
included. No float takes part, so the card and the CPU draw the same sets.

A key is a tuple of two Python ints, (high word, low word); `split` and
`fold_in` stay on the host and launch nothing. Tensor arithmetic is int64
masked to 32 bits, so that the sum, the rotate and the logical right shift
are exact and alike on every device (int32's `>>` is arithmetic), and runs on
the device of the tensor it is given.
"""

from __future__ import annotations

import math

import torch

from .topk import stable_topk

Key = tuple[int, int]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _threefry2x32(k: Key, x1, x2):
    """Threefry-2x32, 20 rounds, of the counter words (x1, x2) under key k:
    Python ints or int64 tensors of 32-bit values, and so is the result."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = (((x2 << r) & M32) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + (ks[(i + 2) % 3] + i + 1)) & M32
    return x1, x2


def _word(x, what: str) -> int:
    x = int(x)
    if not 0 <= x <= M32:
        raise ValueError(f"{what} must lie in [0, 2**32), got {x}")
    return x


def key(seed) -> Key:
    """`jax.random.key(seed)`'s data for 0 <= seed < 2**32: (seed >> 32,
    seed & 0xFFFFFFFF)."""
    seed = _word(seed, "seed")
    return seed >> 32, seed & M32


def split(k: Key, n: int = 2) -> tuple[Key, ...]:
    """`jax.random.split(k, n)`: key i hashes the counter (i >> 32, i)."""
    return tuple(_threefry2x32(k, i >> 32, i & M32) for i in range(n))


def fold_in(k: Key, data) -> Key:
    """`jax.random.fold_in(k, data)`: the hash of `key(data)`'s words."""
    return _threefry2x32(k, *key(_word(data, "data")))


def bits32(k: Key, shape, device=None) -> torch.Tensor:
    """`jax.random.bits(k, shape, jnp.uint32)` as int64 values in [0, 2**32)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32(k, idx >> 32, idx & M32)
    return (b1 ^ b2).reshape(shape)


def uniform(k: Key, shape, device=None, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(k, shape, jnp.float32, minval, maxval)`: the 23
    high bits as the mantissa of a float in [1, 2), less 1, scaled. XLA
    fuses the scale and shift into one multiply-add; here the float32 product
    is exact in float64 and the sum is rounded twice, which differs from one
    rounding only where the float64 sum falls on a float32 midpoint."""
    one = (bits32(k, shape, device) >> 9) | 0x3F800000
    u = one.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=u.device) for v in (minval, maxval))
    scaled = (u.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel_topk_sets(k: Key, valid: torch.Tensor, n_sets: int, n_pick: int) -> torch.Tensor:
    """(n_sets, n_pick) int64 indices into the 1-D mask `valid`, on its
    device: the reference's `top_k(where(valid, gumbel(k, (n_sets, N)),
    -inf), n_pick)`, ranked on the integers under the Gumbel floats. A set
    takes invalid entries, in index order, only when fewer than n_pick are
    valid."""
    u = bits32(k, (n_sets, valid.shape[0]), valid.device) >> 9
    return stable_topk(torch.where(valid[None, :], u, -1), n_pick)[1]
