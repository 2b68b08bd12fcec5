"""k packed rounds applied in order: the plain version of the serve kernel.

    table, resps[k, 9, B], seq' = ring_step(table, qs[k, 12, B], nows[k], seq)

Round b applies `apply_batch_packed_q` at `nows[b]` and sees the effects of
rounds 0..b-1; `seq` (the ring sequence word) advances by k.  The table is
updated in place and returned.  Inactive padding rounds (all-zero rows) are
no-ops.  This is what ops/kernels/serve_kernel.py computes in one dispatch,
and the path its wrapper takes for tensors that lie on the CPU.

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
