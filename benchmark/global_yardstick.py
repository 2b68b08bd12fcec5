"""The GLOBAL cell's yardstick: the bytes a sync must move, each read or
written once, on top of yardstick.useful_bytes (which counts a call's serve
from the replicas).

Frozen here so that a change to the program cannot move its own measuring
stick.  Imports nothing of the program.
"""
from __future__ import annotations

from typing import Sequence

from benchmark.yardstick import useful_bytes

# A staged delta lane: 9 int64 words (key, hits, limit, duration, algo,
# burst, is_greg, greg_expire, greg_duration).
DELTA_LANE_BYTES = 9 * 8
# A broadcast row: 6 int64 words in (key, algo, limit, remaining, status,
# reset_time); the row it leaves is 84 B.
BROADCAST_IN_BYTES = 6 * 8
ROW_BYTES = 84


def sync_bytes(chunk_keys: Sequence[int], n: int, delta_slots: int,
               ways: int) -> int:
    """One sync of chunks holding `chunk_keys[c]` keys each, over n cards:
    for each chunk the staged [n, n, delta_slots] delta grid read once; the
    owners' two rounds over the m merged lanes (both rounds' requests,
    answers and way probes, round 1's read of the row round 0 left, one
    row written a lane); and on each of the n replicas the m broadcast
    rows read, their buckets' key, expire_at and touched words probed
    (24 B a way) and their rows written."""
    total = 0
    for m in chunk_keys:
        total += (DELTA_LANE_BYTES * n * n * delta_slots
                  + useful_bytes(2, 2 * m, m, m, ways)
                  + n * m * (BROADCAST_IN_BYTES + 24 * ways + ROW_BYTES))
    return total


def chunk_keys(owner_counts: Sequence[int], delta_slots: int) -> list:
    """Keys in each chunk of a sync whose keys fall `owner_counts[o]` to
    owner o: an owner's first delta_slots keys in chunk 0, the next in
    chunk 1, and so on."""
    top = max(owner_counts, default=0)
    chunks = -(-top // delta_slots)
    return [sum(min(max(c - j * delta_slots, 0), delta_slots)
                for c in owner_counts) for j in range(chunks)]
