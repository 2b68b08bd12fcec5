"""k packed rounds applied in order: the plain version of the serve kernel.

    table, resps[k, 9, B], seq' = ring_step(table, qs[k, 12, B], nows[k], seq)

Round b applies `apply_batch_packed_q` at `nows[b]` and sees the effects of
rounds 0..b-1; `seq` (the ring sequence word) advances by k.  The table is
updated in place and returned.  Inactive padding rounds (all-zero rows) are
no-ops.  This is what ops/kernels/serve_kernel.py computes in one launch,
and the path its wrapper takes for tensors that lie on the CPU.
"""
from __future__ import annotations

from typing import Tuple

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
