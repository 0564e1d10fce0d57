"""Order-exact selection, scatter and segment-sum helpers.

`jax.lax.top_k` puts the lower index first among equal values, and
`jnp.argsort` is stable; `torch.topk` promises no order among ties and
`torch.argsort` is unstable by default. The map code ranks masks and weights
full of ties (free slots, local keyframes, window cameras), so every top-k of
the port goes through `stable_topk`, which reproduces the reference's order.

A scatter-add of floats on a CUDA device (`index_add_`, `index_put_` with
`accumulate=True`) adds with atomics, in an order that changes from run to
run; the normal equations of the pose graph and of the global BA are built
from such sums, and their low bits decide later loop closures. `segments` +
`segment_sum` add each bucket's values in index order on every device, so a
run on the card is repeatable, and on the CPU the result equals
`index_add_`'s bit for bit.
"""

from __future__ import annotations

import torch


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, ties broken by lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def set_drop(x: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """Out-of-place `x.at[idx].set(values, mode="drop")` along axis 0 for
    indices in [0, len(x)]: writes aimed at len(x) land on a parked sentinel
    row that is sliced away. Targets in range must be unique."""
    pad = torch.zeros((1,) + x.shape[1:], dtype=x.dtype, device=x.device)
    out = torch.cat([x, pad])
    if torch.is_tensor(values):
        values = values.to(x.dtype)
    out[idx] = values
    return out[: x.shape[0]]


def scatter_last(base: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Deterministic last-writer-wins scatter into a copy of the 1-D `base`:
    `base.at[idx].set(values)` as XLA applies it on the CPU (updates in
    order, so the last of several writes to one target wins). The position
    of each update is scatter-maxed, then the winning value is gathered."""
    idx = idx.reshape(-1).long()
    values = values.reshape(-1)
    pos = torch.arange(idx.numel(), device=idx.device)
    last = torch.full(base.shape, -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, idx, pos, reduce="amax", include_self=True)
    return torch.where(last >= 0, values[last.clamp(min=0)].to(base.dtype), base)


def segments(idx: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, counts) of the buckets 0..n-1 that the 1-D `idx` sorts its
    positions into; reusable for every sum over the same `idx`."""
    idx = idx.reshape(-1).long()
    return torch.sort(idx, stable=True)[1], torch.bincount(idx, minlength=n)


def segment_sum(values: torch.Tensor, seg: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """`zeros(n, ...).index_add_(0, idx, values)` for `seg = segments(idx, n)`,
    each bucket summed in the order of its positions in `idx`."""
    order, counts = seg
    return torch.segment_reduce(values[order], "sum", lengths=counts, axis=0)
