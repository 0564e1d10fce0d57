"""A one-axis device mesh and its all-reduce: the counterpart of a
`jax.sharding.Mesh` over one axis with `lax.psum` over it.

A `Mesh` holds the devices of its shards, in order, and optionally a
`torch.distributed` process group. A device may appear more than once: its
shards are then virtual shards on one device, as the JAX package's tests get
from `--xla_force_host_platform_device_count`, and check the sharded
arithmetic without a second card. With a group, every process of the group
holds a mesh of the same shape over its own devices, and the mesh's shards
are those of all processes together (gloo on the CPU, NCCL on the card).

`psum` sums one partial per local shard: the partials are moved to the first
device and added in shard order (no float scatter-add: the sum must not
depend on the timing of atomics), then, with a group, all-reduced over it.
Every process gets the same total, so every process takes the same
decisions from it. The total is replicated back to each shard's device.
"""

from __future__ import annotations

import torch


class Mesh:
    """The devices of a mesh's local shards, and the process group that
    joins the meshes of several processes (None: this process alone)."""

    def __init__(self, devices, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.cache: dict = {}  # solves built for this mesh (`dist_ba.get_sharded_lm_chunk`)

    @property
    def n_local(self) -> int:
        """Shards held by this process."""
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards over all processes of the group."""
        if self.group is None:
            return self.n_local
        import torch.distributed as dist

        return self.n_local * dist.get_world_size(self.group)

    @property
    def home(self) -> torch.device:
        """The first device: where the partials are summed and where the
        replicated quantities of a solve are computed."""
        return self.devices[0]

    def split(self, t: torch.Tensor) -> list[torch.Tensor]:
        """This process's shards of `t` along its leading axis, each on its
        shard's device. The leading size must divide evenly over the local
        shards: pad with invalid slots otherwise."""
        n, s = t.shape[0], self.n_local
        if n % s:
            raise ValueError(f"a leading size of {n} does not divide over {s} shards")
        step = n // s
        return [t[i * step:(i + 1) * step].to(d) for i, d in enumerate(self.devices)]

    def reduce(self, parts):
        """Sum of one partial per local shard (a tensor or a tuple of
        tensors), on the first device, then all-reduced over the group: one
        collective, a tuple's members flattened into one buffer."""
        if len(parts) != self.n_local:
            raise ValueError(f"{len(parts)} partials for {self.n_local} shards")
        single = isinstance(parts[0], torch.Tensor)
        rows = [(p,) if single else tuple(p) for p in parts]
        home = self.home
        total = list(rows[0])
        for row in rows[1:]:
            total = [a + b.to(home) for a, b in zip(total, row)]
        if self.group is not None:
            total = _all_reduce(total, self.group)
        return total[0] if single else tuple(total)

    def replicate(self, t: torch.Tensor) -> list[torch.Tensor]:
        """`t` on every local shard's device (one copy per distinct device)."""
        copies = {}
        return [copies.setdefault(d, t.to(d)) for d in self.devices]

    def psum(self, parts):
        """`lax.psum` over the mesh: the total of the partials, replicated
        to every local shard's device (tuples elementwise)."""
        total = self.reduce(parts)
        if isinstance(total, torch.Tensor):
            return self.replicate(total)
        reps = [self.replicate(t) for t in total]
        return [tuple(r[i] for r in reps) for i in range(self.n_local)]


def _all_reduce(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def resolve(mesh):
    """A caller's mesh: a `Mesh`, a sequence of devices, "auto" (every
    visible card) or None. Returns a `Mesh`, or None where a mesh of one
    shard would add nothing (the single-device solves then run)."""
    if mesh is None:
        return None
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f'mesh must be a Mesh, a sequence of devices, "auto" or None, not {mesh!r}')
        mesh = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not isinstance(mesh, Mesh):
        mesh = Mesh(list(mesh)) if len(mesh) else None
    return mesh if mesh is not None and mesh.size > 1 else None
