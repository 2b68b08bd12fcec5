"""Key->shard routing and the per-shard views of one table.

The JAX package shards its slot table over a one-axis device mesh (the
`shard` axis): shard `s` owns rows [s*L, (s+1)*L) of every column, L =
num_slots / num_shards, and a request's 64-bit key fingerprint selects the
owning shard.  On one card the axis becomes a leading index over contiguous
column slices of ONE table, so the layout is the JAX package's word for word
(a snapshot of either is the other's checkpoint).  There is no mesh object
and no process group: a shard is a view.

Routing uses hash bits 32.. (disjoint from the bucket-index bits, which come
from the LOW bits: ops/step.py bucket = h & (nb_local - 1)), so the same
fingerprint drives both levels without correlation.  Routing happens on the
host, so any shard count works (modulo); only the per-shard bucket count must
stay a power of two for the device-side mask.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gubernator_tpu_torch.ops.state import SlotTable

SHARD_AXIS = "shard"
_SHARD_SHIFT = 32


def shard_of_hash(h, num_shards: int):
    """Owning shard for a 64-bit key fingerprint (a Python int or a numpy
    array; int64 arrays are read as their unsigned bits).

    Replaces the worker-pool hash-range interpolation (workers.go:182-186)
    and the intra-pod consistent-hash lookup (replicated_hash.go:104-118)
    with a mask over high hash bits."""
    u = np.uint64(h) if np.isscalar(h) else np.asarray(h).astype(np.uint64)
    return (u >> np.uint64(_SHARD_SHIFT)) % np.uint64(num_shards)


def shard_view(table: SlotTable, s: int, num_shards: int) -> SlotTable:
    """Shard `s`'s table: every column sliced [s*L, (s+1)*L).  The slices
    are views, so an op that writes a view writes the base table."""
    L = table.key.shape[0] // num_shards
    return SlotTable(*[c[s * L:(s + 1) * L] for c in table])


def claim_view(claim: Optional[torch.Tensor], s: int,
               num_shards: int) -> Optional[torch.Tensor]:
    """Shard `s`'s slice of a table's claim-word buffer (None on the CPU,
    where the plain path takes none)."""
    if claim is None:
        return None
    L = claim.shape[0] // num_shards
    return claim[s * L:(s + 1) * L]
