"""The shard placement, key->shard routing, and tensors split over shards.

The JAX package shards its slot table over a one-axis device mesh (the
`shard` axis, gubernator_tpu/parallel/mesh.py `make_mesh`): shard `s` owns
rows [s*L, (s+1)*L) of every column, L = num_slots / num_shards, on the
mesh's device s, and a request's 64-bit key fingerprint selects the owning
shard.  Here `make_mesh` returns the placement, one torch device a shard,
and each shard keeps its own table on its device (parallel/sharded.py).  A
snapshot concatenates the shards in shard order, so either package's
snapshot is the other's checkpoint.

The placement wraps where the JAX mesh raises: shard s goes on
`devices[s % len(devices)]`, so four shards fit one card (every shard on
it), four cards (one each) or the CPU.  There is no process group: one
process drives every card, each shard on its own stream.

Routing uses hash bits 32.. (disjoint from the bucket-index bits, which come
from the LOW bits: ops/step.py bucket = h & (nb_local - 1)), so the same
fingerprint drives both levels without correlation.  Routing happens on the
host, so any shard count works (modulo); only the per-shard bucket count must
stay a power of two for the device-side mask.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch.ops.kernels import resolve_device

SHARD_AXIS = "shard"
_SHARD_SHIFT = 32


def make_mesh(num_shards: int, device="cuda",
              devices: Optional[Sequence] = None,
              who: str = "mesh") -> List[torch.device]:
    """Shard s's device, for s < num_shards: `devices[s % len(devices)]`.

    Without `devices`: every visible card when `device` is "cuda" with no
    index, else `device` alone (the CPU, or one named card)."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    if devices is None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            resolve_device(dev, who)
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [dev]
    devs = [resolve_device(d, who) for d in devices]
    if not devs:
        raise ValueError("devices: need at least one device")
    return [devs[s % len(devs)] for s in range(num_shards)]


def shard_of_hash(h, num_shards: int):
    """Owning shard for a 64-bit key fingerprint (a Python int or a numpy
    array; int64 arrays are read as their unsigned bits).

    Replaces the worker-pool hash-range interpolation (workers.go:182-186)
    and the intra-pod consistent-hash lookup (replicated_hash.go:104-118)
    with a mask over high hash bits."""
    u = np.uint64(h) if np.isscalar(h) else np.asarray(h).astype(np.uint64)
    return (u >> np.uint64(_SHARD_SHIFT)) % np.uint64(num_shards)


class ShardedTensor:
    """A tensor split over the shards, the counterpart of a JAX array
    sharded on the mesh: part s lives on shard s's device and is made on
    shard s's stream (`streams[s]`, None on the CPU), and the whole is the
    parts stacked on `axis`.  Nothing is assembled on a device; `numpy()`
    assembles the whole on the host, each part copied on its own stream."""

    __slots__ = ("parts", "streams", "axis")

    def __init__(self, parts: Sequence[torch.Tensor],
                 streams: Sequence[Optional["torch.cuda.Stream"]],
                 axis: int = 0) -> None:
        self.parts = list(parts)
        self.streams = list(streams)
        self.axis = axis

    @property
    def shape(self) -> tuple:
        s = list(self.parts[0].shape)
        return tuple(s[:self.axis] + [len(self.parts)] + s[self.axis:])

    def numpy(self) -> np.ndarray:
        host = []
        for p, st in zip(self.parts, self.streams):
            if st is None:
                host.append(p.numpy())
            else:
                with torch.cuda.stream(st):
                    host.append(p.cpu().numpy())
        return np.stack(host, axis=self.axis)

    def tolist(self) -> list:
        return self.numpy().tolist()

    def unflatten(self, dim: int, sizes: Sequence[int]) -> "ShardedTensor":
        """Split leading dim `dim` (before the shard axis) into `sizes`,
        as torch.Tensor.unflatten does."""
        if dim >= self.axis:
            raise ValueError("unflatten: only dims before the shard axis")
        return ShardedTensor([p.unflatten(dim, sizes) for p in self.parts],
                             self.streams, self.axis + len(sizes) - 1)
