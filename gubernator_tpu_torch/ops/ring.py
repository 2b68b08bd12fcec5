"""k packed rounds applied in order: the plain version of the serve kernel.

    table, resps[k, 9, B], seq' = ring_step(table, qs[k, 12, B], nows[k], seq)

Round b applies `apply_batch_packed_q` at `nows[b]` and sees the effects of
rounds 0..b-1; `seq` (the ring sequence word) advances by k.  The table is
updated in place and returned.  Inactive padding rounds (all-zero rows) are
no-ops.  This is what ops/kernels/serve_kernel.py computes in one dispatch,
and the path its wrapper takes for tensors that lie on the CPU.

`mega_ring_step` is the megaround form: r x s rounds, [r, s, 12, B],
applied in order as one flat ring of r*s rounds; the resolve_* helpers and
`ring_tier_of` give the power-of-two block tiers the ring runner pads to
(runtime/ring.py).

`owner_partition` is the plain form of that kernel's binning: it splits
each round's active lanes by the block that owns their bucket.  Every
dependency of a round is local to a bucket, so `ring_step` applied owner by
owner, with the other owners' lanes inactive, gives the same responses and
table as one whole `ring_step`; the tests hold that premise.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from gubernator_tpu_torch.ops.state import SlotTable
from gubernator_tpu_torch.ops.step import apply_batch_packed_q


def ring_step(
    table: SlotTable,
    qs: torch.Tensor,    # int64[k, 12, B]
    nows: torch.Tensor,  # int64[k]
    seq: torch.Tensor,   # int64[] ring sequence word
    ways: int = 8,
) -> Tuple[SlotTable, torch.Tensor, torch.Tensor]:
    """Apply `k` packed rounds in order; returns
    (table, int64[k, 9, B] packed responses, seq + k)."""
    resps = []
    for b in range(qs.shape[0]):
        table, resp = apply_batch_packed_q(table, qs[b], nows[b], ways)
        resps.append(resp)
    if resps:
        out = torch.stack(resps)
    else:
        out = torch.empty(
            (0, 9, qs.shape[-1]), dtype=torch.int64, device=qs.device
        )
    return table, out, seq + qs.shape[0]


def mega_ring_step(
    table: SlotTable,
    qs: torch.Tensor,    # int64[r, s, 12, B]
    nows: torch.Tensor,  # int64[r, s]
    seq: torch.Tensor,   # int64[]
    ways: int = 8,
) -> Tuple[SlotTable, torch.Tensor, torch.Tensor]:
    """Megaround: apply the r x s rounds in order (a scan of `ring_step`
    over the r ring rounds); returns (table, int64[r, s, 9, B],
    seq + r*s)."""
    r, s = qs.shape[0], qs.shape[1]
    table, resps, seq = ring_step(
        table, qs.reshape((r * s,) + tuple(qs.shape[2:])),
        nows.reshape(r * s), seq, ways)
    return table, resps.reshape((r, s) + tuple(resps.shape[1:])), seq


def resolve_ring_tiers(slots: int) -> Tuple[int, ...]:
    """Block tiers of the ring: powers of two up to `slots`, then `slots`
    (a partial block pads to the smallest tier that holds it)."""
    tiers = []
    t = 1
    while t < slots:
        tiers.append(t)
        t <<= 1
    tiers.append(slots)
    return tuple(tiers)


def resolve_mega_tiers(slots: int, rounds: int) -> Tuple[int, ...]:
    """Mega tiers past the base capacity: `slots x m` rounds for each
    ring-round tier m in (1, rounds].  Empty when rounds == 1."""
    return tuple(slots * m for m in resolve_ring_tiers(rounds) if m > 1)


def ring_tier_of(k: int, tiers: Tuple[int, ...]) -> int:
    """Smallest tier holding `k` stacked rounds."""
    for t in tiers:
        if k <= t:
            return t
    return tiers[-1]


def owner_partition(
    qs: torch.Tensor,  # int64[k, 12, B]
    num_buckets: int,
    owners: int,
) -> Tuple[torch.Tensor, List[List[torch.Tensor]]]:
    """Each round's active lanes by owner = bucket % owners, where bucket =
    h & (num_buckets - 1).  Returns (owner int64[k, B], -1 on inactive
    lanes; lists[b][g], the lane ids of round b that owner g holds, in
    ascending order).  Every active lane is in exactly one list."""
    if num_buckets <= 0 or num_buckets & (num_buckets - 1):
        raise ValueError(f"num_buckets ({num_buckets}) must be a power of two")
    if owners < 1:
        raise ValueError(f"owners ({owners}) must be positive")
    bucket = qs[:, 0] & (num_buckets - 1)
    owner = torch.where(qs[:, 10] != 0, bucket % owners,
                        torch.full_like(bucket, -1))
    lists = [[(row == g).nonzero().flatten() for g in range(owners)]
             for row in owner]
    return owner, lists
