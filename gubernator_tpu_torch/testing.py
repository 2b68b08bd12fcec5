"""Seeded random slot tables and packed rounds that reach every branch of the
decision step: found / new / cached rows, token and leaky paths, limit and
duration changes, RESET_REMAINING, Gregorian lanes, hits of 0 / negative /
over the limit, crowded buckets that need all three claim rounds and leave
lanes transient, expired rows, tied touch stamps (lowest way wins), inactive
lanes holding garbage, an algorithm id that is neither bucket, and a few
lanes and rows at the int64 extremes (saturation, wrap, truncation).

Everything is numpy from a `np.random.Generator`, so the same inputs can be
handed to this package and to the JAX package.  Tables use the snapshot
dict format (ops/state.table_from_host); rounds are int64[k, 12, B].
"""
from __future__ import annotations

from typing import Dict

import numpy as np

I64_MAX = 2**63 - 1
I64_MIN = -(2**63)
EXTREMES = np.array([
    I64_MAX, I64_MIN, I64_MAX - 1, I64_MIN + 1, 2**62, -(2**62),
    2**53 + 1, -(2**53) - 1, 2**31, -(2**31) - 1,
], dtype=np.int64)


class KeySpace:
    """Fingerprints grouped by bucket: a few HOT buckets hold three times
    `ways` candidate keys each (so inserts contend), the rest are drawn
    fresh."""

    def __init__(self, rng: np.random.Generator, num_slots: int, ways: int,
                 hot_buckets: int = 4):
        self.rng = rng
        self.ways = ways
        self.nb = num_slots // ways
        self.hot = rng.choice(self.nb, size=min(hot_buckets, self.nb),
                              replace=False)
        self.hot_keys = np.unique(np.concatenate([
            self.in_bucket(np.full(3 * ways, b)) for b in self.hot
        ]))

    def in_bucket(self, buckets: np.ndarray) -> np.ndarray:
        """Random nonzero fingerprints (negative ones too) whose bucket is
        `buckets`."""
        raw = self.rng.integers(I64_MIN, I64_MAX, size=len(buckets),
                                dtype=np.int64, endpoint=True)
        h = (raw & ~np.int64(self.nb - 1)) | buckets.astype(np.int64)
        return np.where(h == 0, np.int64(self.nb), h)


def random_table(rng: np.random.Generator, ks: KeySpace,
                 now: int) -> Dict[str, np.ndarray]:
    S = ks.nb * ks.ways
    bucket = np.arange(S) // ks.ways
    key = np.where(rng.random(S) < 0.7, ks.in_bucket(bucket), 0)
    for b in ks.hot:  # hot buckets: full, with keys the rounds will ask for
        own = ks.hot_keys[(ks.hot_keys & (ks.nb - 1)) == b]
        key[b * ks.ways:(b + 1) * ks.ways] = rng.choice(
            own, ks.ways, replace=False)
    t = dict(
        key=key.astype(np.int64),
        algo=rng.integers(0, 2, S).astype(np.int32),
        kind=(rng.random(S) < 0.15).astype(np.int32),
        limit=rng.choice([0, 1, 2, 10, 100, 2000], S).astype(np.int64),
        duration=rng.choice([5, 1000, 30_000, 60_000], S).astype(np.int64),
        remaining=rng.integers(-3, 2000, S).astype(np.int64),
        remaining_f=np.round(rng.random(S) * 120.0, rng.integers(0, 3)),
        t0=now - rng.integers(0, 200_000, S),
        status=rng.integers(0, 2, S).astype(np.int32),
        burst=rng.choice([0, 1, 10, 20, 100, 2000], S).astype(np.int64),
        expire_at=now + rng.integers(-60_000, 60_000, S),
        # Few distinct stamps: ties decide by the lowest way.
        touched=now - rng.choice([0, 5, 1000, 100_000], S),
    )
    hostile = rng.random(S) < 0.03
    for f in ("limit", "duration", "remaining", "t0", "burst"):
        pick = hostile & (rng.random(S) < 0.5)
        t[f][pick] = rng.choice(EXTREMES, int(pick.sum()))
    return t


def random_rounds(rng: np.random.Generator, ks: KeySpace,
                  table_keys: np.ndarray, k: int, B: int,
                  now: int) -> np.ndarray:
    """int64[k, 12, B]; keys unique within each round (the packer's
    contract), repeated across rounds."""
    live = np.unique(table_keys[table_keys != 0])
    qs = np.zeros((k, 12, B), dtype=np.int64)
    for b in range(k):
        n_hot = min(len(ks.hot_keys), B // 4)
        n_old = min(len(live), B // 2)
        cand = np.concatenate([
            rng.choice(ks.hot_keys, n_hot, replace=False),
            rng.choice(live, n_old, replace=False),
            ks.in_bucket(rng.integers(0, ks.nb, B)),
        ])
        cand = cand[np.sort(np.unique(cand, return_index=True)[1])]
        q = qs[b]
        q[0] = rng.permutation(cand)[:B]
        q[1] = rng.choice([0, 1, 1, 1, 2, 5, -1, 100], B)
        q[2] = rng.choice([0, 1, 2, 10, 100, 2000], B)
        q[3] = rng.choice([5, 1000, 30_000, 60_000], B)
        q[4] = np.where(rng.random(B) < 0.02, 2, rng.integers(0, 2, B))
        q[5] = rng.choice([0, 1, 10, 20, 100, 2000], B)
        q[6] = rng.random(B) < 0.1
        q[7] = rng.random(B) < 0.1
        q[8] = now + rng.integers(-1000, 3_600_000, B)
        q[9] = rng.choice([60_000, 3_600_000, 86_400_000], B)
        q[11] = rng.random(B) < 0.3
        hostile = rng.random(B) < 0.03
        for row in (1, 2, 3, 5, 8, 9):
            pick = hostile & (rng.random(B) < 0.5)
            q[row][pick] = rng.choice(EXTREMES, int(pick.sum()))
        active = rng.random(B) < 0.85
        # Inactive lanes carry garbage: the step must ignore it.
        q[10] = active
        q[:, ~active] = np.where(
            rng.random((12, int((~active).sum()))) < 0.5,
            q[:, ~active], 7)
        q[10, ~active] = 0
    return qs
