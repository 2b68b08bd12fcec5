"""The slot table: device-resident rate-limit state as 12 torch tensors.

A W-way set-associative table held as a struct of arrays (reference
counterpart: the per-worker LRU dict, lrucache.go:32-223).  A key's 64-bit
fingerprint selects one bucket of `ways` slots; lookups read every way and
match the stored fingerprint; inserts pick a victim way (own stale > empty >
expired > least recently touched).

`table_to_host` / `table_from_host` use the host dict format of
`gubernator_tpu`'s `DeviceBackend.snapshot()` (field name -> numpy array of
the same dtype), so a table moves between the two engines unchanged.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Union

import numpy as np
import torch

# Slot `kind` values.
KIND_BUCKET = 0
KIND_CACHED_RESP = 1  # non-owner's cached GLOBAL broadcast (gubernator.go:464-479)


class SlotTable(NamedTuple):
    """One row = one CacheItem (cache.go:30-42) flattened together with its
    TokenBucketItem / LeakyBucketItem payload (store.go:29-43)."""

    key: torch.Tensor          # int64[S]; xxhash64 fingerprint; 0 = empty
    algo: torch.Tensor         # int32[S]; Algorithm enum
    kind: torch.Tensor         # int32[S]; KIND_*
    limit: torch.Tensor        # int64[S]
    duration: torch.Tensor     # int64[S]
    remaining: torch.Tensor    # int64[S]; token remaining / cached-resp remaining
    remaining_f: torch.Tensor  # float64[S]; leaky-bucket fractional remaining
    t0: torch.Tensor           # int64[S]; token CreatedAt / leaky UpdatedAt
    status: torch.Tensor       # int32[S]; token sticky status / cached-resp status
    burst: torch.Tensor        # int64[S]
    expire_at: torch.Tensor    # int64[S]; unix ms (CacheItem.ExpireAt)
    touched: torch.Tensor      # int64[S]; last-access stamp for victim choice

    def occupancy(self) -> torch.Tensor:
        return (self.key != 0).sum()


COLUMN_DTYPES: Dict[str, torch.dtype] = {
    "key": torch.int64,
    "algo": torch.int32,
    "kind": torch.int32,
    "limit": torch.int64,
    "duration": torch.int64,
    "remaining": torch.int64,
    "remaining_f": torch.float64,
    "t0": torch.int64,
    "status": torch.int32,
    "burst": torch.int64,
    "expire_at": torch.int64,
    "touched": torch.int64,
}


def init_table(
    num_slots: int, device: Union[str, torch.device] = "cuda"
) -> SlotTable:
    """All-empty table on `device`."""
    return SlotTable(**{
        f: torch.zeros(num_slots, dtype=dt, device=device)
        for f, dt in COLUMN_DTYPES.items()
    })


def table_to_host(table: SlotTable) -> Dict[str, np.ndarray]:
    """Copy the table to host numpy arrays (snapshot / Loader-save form).
    Always a copy: the table is updated in place, so a view of a CPU
    table would change under the snapshot's holder."""
    return {
        f: getattr(table, f).to("cpu", copy=True).numpy()
        for f in SlotTable._fields
    }


def table_from_host(
    arrs: Dict[str, np.ndarray], device: Union[str, torch.device] = "cuda"
) -> SlotTable:
    """Upload host arrays (the snapshot dict format) as a table."""
    return SlotTable(**{
        f: torch.from_numpy(np.array(arrs[f])).to(device=device, dtype=dt)
        for f, dt in COLUMN_DTYPES.items()
    })


def clone_table(table: SlotTable) -> SlotTable:
    return SlotTable(*[c.clone() for c in table])
