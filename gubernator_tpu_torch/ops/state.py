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


# --------------------------------------------------------------------------
# The state plane: live slot migration (runtime/reshard.py), the cold tier's
# demotion (runtime/coldtier.py) and the gubstat census (runtime/gubstat.py).
# Plain torch ops on the table's device, held bit-exact against the JAX
# package's ops/state.py.  The JAX forms build a new table; these update it
# in place and return it.  Every gather of a mutating op is a fresh tensor
# made before its first write, so the rows it returns are the rows as they
# stood before the clear.
# --------------------------------------------------------------------------

I64_MAX = 2**63 - 1


def migrate_extract(
    table: SlotTable,
    h: torch.Tensor,  # int64[B] key fingerprints; 0 = inactive lane
    now,
    ways: int = 8,
):
    """Probe `h`, gather each found row's fields, and CLEAR the matched
    slots (key = 0, expire_at = 0) in the same call: between the gather and
    the clear nothing else touches the table, so a moved row exists in one
    table at every instant the backend lock is free.  Returns (table,
    int64[10, B] in ops.step.GATHER_ROW_FIELDS order, float64[B]
    remaining_f)."""
    from gubernator_tpu_torch.ops.step import _pack_row_fields, probe_batch

    found, src = probe_batch(table, h, now, ways)
    packed = _pack_row_fields(found, table, src)
    rf = table.remaining_f[src]
    # Clear: drop the fingerprint AND the expiry so the slot reads as
    # empty to every probe and as a first-choice victim.
    tgt = src[found]
    table.key[tgt] = 0
    table.expire_at[tgt] = 0
    return table, packed, rf


def migrate_inject(
    table: SlotTable,
    rows,  # ops.step.BucketRows; key_hash 0 = inactive lane
    now,
    ways: int = 8,
):
    """Upsert migrated rows where the key is absent; where it is already
    resident, MERGE by subtracting the migrated row's consumed budget
    (limit - remaining, clamped at 0) from the resident row — total
    consumption is the sum of both rows', clamped at the limit, so the
    merge can only lower remaining.  Returns (table, bool[B] resident-before
    mask).  The caller guards chunk replays (runtime/reshard.py keys
    delivered fingerprints per handoff epoch).

    Order matters and follows the JAX form: probe, upsert with the
    conflict lanes masked out, then the merge reads `remaining` and
    `remaining_f` at the probed slots AFTER the upsert (the upsert did not
    write the conflict lanes, but it may have claimed one of their slots
    as an insert victim, and then the merge reads the new row)."""
    from gubernator_tpu_torch.ops.step import (
        _device_i64,
        load_rows,
        probe_batch,
    )

    h = rows.key_hash
    now = _device_i64(now, h.device)
    found, slot = probe_batch(table, h, now, ways)
    load_rows(table, rows._replace(key_hash=torch.where(found, 0, h)),
              now, ways)
    conflict = found & (h != 0)
    consumed_i = torch.clamp(rows.limit - rows.remaining, min=0)
    consumed_f = torch.maximum(
        rows.limit.to(torch.float64) - rows.remaining_f,
        torch.zeros((), dtype=torch.float64, device=h.device),
    )
    is_leaky = rows.algo == 1
    src = torch.where(conflict, slot, 0)
    merged_rem = torch.clamp(
        table.remaining[src] - torch.where(is_leaky, 0, consumed_i), min=0
    )
    merged_rf = torch.maximum(
        table.remaining_f[src] - torch.where(is_leaky, consumed_f, 0.0),
        torch.zeros((), dtype=torch.float64, device=h.device),
    )
    idx = conflict.nonzero().squeeze(1)  # one host sync for both writes
    tgt = slot[idx]
    table.remaining[tgt] = merged_rem[idx]
    table.remaining_f[tgt] = merged_rf[idx]
    return table, found


# Packed demote row layout: GATHER_ROW_FIELDS with the `found` word replaced
# by the row's own fingerprint (the op picked the rows; 0 = inactive lane).
DEMOTE_ROW_FIELDS = (
    "key", "kind", "algo", "limit", "duration", "remaining", "t0",
    "status", "burst", "expire_at",
)


def demote_extract(
    table: SlotTable,
    protect: torch.Tensor,  # int64[M] shadow-plane fingerprints; 0 = inactive
    now,
    ways: int = 8,
    batch: int = 64,
):
    """Pick the `batch` coldest (least recently touched) live KIND_BUCKET
    rows whose fingerprint is not in `protect`, gather them, and CLEAR their
    slots (key = 0, expire_at = 0) in the same call.  Returns (table,
    int64[10, batch] in DEMOTE_ROW_FIELDS order, float64[batch]
    remaining_f); lanes past the eligible population are all zero.

    The JAX form ranks with lax.top_k(-score), which puts the lower slot
    index first among equal scores.  torch.topk promises no order on ties,
    and ties are the norm (a whole batch shares one `now`), so the ranking
    here is a stable sort of the score over the whole table: equal stamps
    keep slot order.  `protect` is tested with isin, not an [S, M]
    comparison (1 GiB of bools at 2^24 slots and M = 64)."""
    now = int(now) if not isinstance(now, torch.Tensor) else now
    alive = (table.key != 0) & (table.expire_at > now)
    eligible = alive & (table.kind == KIND_BUCKET)
    # Zero fingerprints in `protect` only match empty slots, which are
    # not alive, so inactive lanes need no mask.
    eligible &= ~torch.isin(table.key, protect)
    score = torch.where(eligible, table.touched, I64_MAX)
    vals, idx = torch.sort(score, stable=True)
    vals, idx = vals[:batch], idx[:batch]
    sel = vals != I64_MAX
    src = torch.where(sel, idx, 0)

    def g(col: torch.Tensor) -> torch.Tensor:
        return torch.where(sel, col[src].to(torch.int64), 0)

    packed = torch.stack([
        g(table.key), g(table.kind), g(table.algo), g(table.limit),
        g(table.duration), g(table.remaining), g(table.t0),
        g(table.status), g(table.burst), g(table.expire_at),
    ])
    rf = torch.where(sel, table.remaining_f[src], 0.0)
    tgt = idx[sel]
    table.key[tgt] = 0
    table.expire_at[tgt] = 0
    return table, packed, rf


# The reserved derived-slot suffix classes, in census-row order (a wire
# contract with runtime/gubstat.py).  The table stores only fingerprints,
# so the host enumerates the derived keys it knows and passes their
# fingerprints per class; the census counts the live residents.
SHADOW_PLANES = (
    ".hot-mirror", ".lease-grant", ".degraded-shadow",
    ".handoff-shadow", ".region-carve",
)

# Slot-age / TTL-remaining histogram edges (ms): <=1s, <=10s, <=1m, <=10m,
# <=1h, >1h.
AGE_BIN_EDGES_MS = (1_000, 10_000, 60_000, 600_000, 3_600_000)
AGE_BINS = len(AGE_BIN_EDGES_MS) + 1

# Remaining-fraction bins over [0, 1] (bin k covers [k/8, (k+1)/8)).
FRAC_BINS = 8


class TableStats(NamedTuple):
    """One census of the table (all int64 counts)."""

    occupancy: torch.Tensor           # int64[]: slots with a fingerprint
    live: torch.Tensor                # int64[]: resident AND unexpired
    expired_resident: torch.Tensor    # int64[]: resident but TTL-passed
    bucket_fill: torch.Tensor         # int64[ways+1]: buckets with k residents
    slot_age: torch.Tensor            # int64[AGE_BINS]: now - t0, live only
    ttl_remaining: torch.Tensor       # int64[AGE_BINS]: expire_at - now, live
    remaining_fraction: torch.Tensor  # int64[2, FRAC_BINS]: per algo enum
    shadow_slots: torch.Tensor        # int64[len(SHADOW_PLANES)]: live carves


def _bin_counts(idx: torch.Tensor, k: int) -> torch.Tensor:
    """int64[k] counts of the values 0..k-1 in `idx` (integers in [0, k]).
    A histogram over unit-wide bins in float64, which is exact for counts
    below 2^53; each value sits at its bin's centre, so the bin index is
    exact whichever order histc scales in.  Unlike bincount it never reads
    the maximum back to the host, so it queues behind the serving launches
    without a sync."""
    return torch.histc(
        idx.to(torch.float64) + 0.5, bins=k + 1, min=0, max=k + 1
    )[:k].to(torch.int64)


def _age_bin(values: torch.Tensor) -> torch.Tensor:
    """Number of AGE_BIN_EDGES_MS strictly below each value (the JAX
    form's sum of `values > edge`)."""
    idx = torch.zeros_like(values)
    for e in AGE_BIN_EDGES_MS:
        idx += values > e
    return idx


def table_stats(
    table: SlotTable,
    shadow_fps: torch.Tensor,  # int64[len(SHADOW_PLANES), M]; 0 = inactive
    now,
    ways: int = 8,
) -> TableStats:
    """The whole census in one read-only pass (the JAX form's
    table_stats): occupancy, bucket fill, slot-age and TTL histograms of
    live rows, the remaining-fraction distribution per algorithm, and the
    live residents among the host-enumerated shadow fingerprints.  Never
    writes the table.  Histograms count with _bin_counts (one pass each)
    instead of the JAX form's [S, bins] one-hot sums; the counts are
    equal."""
    S = table.key.shape[0]
    nb = S // ways
    now = int(now) if not isinstance(now, torch.Tensor) else now
    resident = table.key != 0
    alive = resident & (table.expire_at > now)
    occupancy = resident.sum(dtype=torch.int64)
    live = alive.sum(dtype=torch.int64)

    per_bucket = resident.view(nb, ways).sum(dim=1, dtype=torch.int64)
    bucket_fill = _bin_counts(per_bucket, ways + 1)

    def hist(values: torch.Tensor) -> torch.Tensor:
        return _bin_counts(
            torch.where(alive, _age_bin(values), AGE_BINS), AGE_BINS
        )

    slot_age = hist(now - table.t0)
    ttl_remaining = hist(table.expire_at - now)

    # Remaining fraction, in float64 and in the JAX form's order: divide
    # by max(limit, 1), clip to [0, 1], times FRAC_BINS, truncate, cap.
    lim_f = torch.clamp(table.limit.to(torch.float64), min=1.0)
    rem_f = torch.where(
        table.algo == 1, table.remaining_f, table.remaining.to(torch.float64)
    )
    frac = torch.clamp(rem_f / lim_f, 0.0, 1.0)
    fbin = torch.clamp((frac * FRAC_BINS).to(torch.int32), max=FRAC_BINS - 1)
    algo = table.algo.to(torch.int64)
    fidx = torch.where(
        alive & ((algo == 0) | (algo == 1)),
        algo * FRAC_BINS + fbin,
        2 * FRAC_BINS,
    )
    remaining_fraction = _bin_counts(fidx, 2 * FRAC_BINS).view(2, FRAC_BINS)

    # Shadow census: the probe's bucket walk over each host-enumerated
    # fingerprint, read-only.
    fp = shadow_fps.reshape(-1)
    bucket = fp & (nb - 1)
    sidx = bucket[:, None] * ways + torch.arange(ways, device=fp.device)[None, :]
    match = (
        (table.key[sidx] == fp[:, None])
        & (fp[:, None] != 0)
        & (table.expire_at[sidx] > now)
    )
    shadow_slots = match.any(dim=1).view(shadow_fps.shape).sum(
        dim=1, dtype=torch.int64
    )
    return TableStats(
        occupancy=occupancy,
        live=live,
        expired_resident=occupancy - live,
        bucket_fill=bucket_fill,
        slot_age=slot_age,
        ttl_remaining=ttl_remaining,
        remaining_fraction=remaining_fraction,
        shadow_slots=shadow_slots,
    )
