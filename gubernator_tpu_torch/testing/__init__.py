"""Seeded random slot tables and packed rounds that reach every branch of the
decision step: found / new / cached rows, token and leaky paths, limit and
duration changes, RESET_REMAINING, Gregorian lanes, hits of 0 / negative /
over the limit, crowded buckets that need all three claim rounds and leave
lanes transient, expired rows, tied touch stamps (lowest way wins), inactive
lanes holding garbage, an algorithm id that is neither bucket, and a few
lanes and rows at the int64 extremes (saturation, wrap, truncation).
`owner_crowded_rounds` puts every active lane of a round in the buckets of
one owner of the serve kernel's binning (bucket % owners == 0).

The sketch tier has its own makers (`random_sketch`, `random_sketch_lanes`,
`window_now`): sketches with cells near both int32 bounds and above 2^24,
and merges with inactive lanes, duplicate-key groups, fingerprints at the
int64 bounds and with the top bit set, zero and negative hits, and every
window case of the rotation.  `cross_chunk_lanes` makes a merge in which one
key crosses its limit in a chosen chunk, so each chunk must read the adds of
the chunks before it.

Everything is numpy from a `np.random.Generator`, so the same inputs can be
handed to this package and to the JAX package.  Tables use the snapshot
dict format (ops/state.table_from_host); rounds are int64[k, 12, B].
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.ops.sketch import row_columns

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


def owner_crowded_rounds(rng: np.random.Generator, ks: KeySpace,
                         table_keys: np.ndarray, k: int, B: int, now: int,
                         owners: int) -> np.ndarray:
    """`random_rounds` whose active lanes all lie in buckets that are 0 mod
    `owners`, so one owner receives every whole round.  Up to half of each
    round's keys are live table keys of those buckets, the rest fresh
    fingerprints there: lanes find, insert, contend and go transient."""
    qs = random_rounds(rng, ks, table_keys, k, B, now)
    keys = table_keys[table_keys != 0]
    live = np.unique(keys[(keys & (ks.nb - 1)) % owners == 0])
    mine = np.arange(0, ks.nb, owners)
    for b in range(k):
        act = qs[b, 10] != 0
        n = int(act.sum())
        cand = np.concatenate([
            rng.choice(live, min(len(live), n // 2), replace=False),
            ks.in_bucket(rng.choice(mine, 2 * n)),
        ])
        cand = cand[np.sort(np.unique(cand, return_index=True)[1])]
        qs[b, 0, act] = rng.permutation(cand[:n])
    return qs


# -- the sketch tier -------------------------------------------------------

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)

WINDOW_CASES = ("in_window", "sliding", "one_behind", "far_behind",
                "before_start")


def random_sketch(rng: np.random.Generator, depth: int, width: int,
                  window_start: int, window_ms: int,
                  big_keys: np.ndarray) -> Dict[str, object]:
    """cur / prev int32[D, W] with small counts (negative ones too), a few
    cells above 2^24 and near INT32_MIN, and every cell of each `big_keys`
    fingerprint near INT32_MAX (so its estimate saturates and its adds
    wrap).  Returns the state as a dict of numpy arrays and ints."""
    cur = rng.integers(-20, 200, (depth, width)).astype(np.int32)
    prev = rng.integers(-20, 200, (depth, width)).astype(np.int32)
    for t in (cur, prev):
        n = max(1, t.size // 64)
        flat = t.reshape(-1)
        flat[rng.integers(0, t.size, n)] = rng.integers(2**24, 2**31 - 1, n)
        flat[rng.integers(0, t.size, n)] = I32_MIN + rng.integers(0, 50, n)
    cols = row_columns(torch.from_numpy(big_keys), depth, width).numpy()
    for d in range(depth):
        cur[d, cols[d]] = I32_MAX - rng.integers(0, 3, len(big_keys))
        prev[d, cols[d]] = rng.choice([I32_MAX, 2**30, 2**24 + 1],
                                      len(big_keys))
    return dict(cur=cur, prev=prev, window_start=int(window_start),
                window_ms=int(window_ms))


def random_sketch_lanes(
    rng: np.random.Generator, k: int, B: int, big_keys: np.ndarray,
    huge_hits: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(kh int64[k, B], hits int32[k, B], lim int32[k, B]) for one merge:
    ~10% inactive lanes (fingerprint 0, garbage hits and limits), groups
    of duplicate keys inside a chunk and across chunks, the big keys, and
    fingerprints at the int64 bounds.  With `huge_hits`, ~1% of lanes
    carry hits at the int32 bounds or beyond 2^24, where the JAX package's
    float32 one-hot and Pallas forms part from its int32 scatter form."""
    n = k * B
    kh = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64, endpoint=True)
    pick = rng.random(n)
    group = rng.integers(I64_MIN, I64_MAX, 8, dtype=np.int64, endpoint=True)
    dup = pick < 0.15
    kh[dup] = rng.choice(group, int(dup.sum()))
    big = (pick >= 0.15) & (pick < 0.17)
    kh[big] = rng.choice(big_keys, int(big.sum()))
    edge = (pick >= 0.17) & (pick < 0.18)
    kh[edge] = rng.choice(
        np.array([I64_MIN, I64_MAX, -1, 1, I64_MIN + 1], dtype=np.int64),
        int(edge.sum()))
    kh[kh == 0] = 1
    kh[pick >= 0.9] = 0  # inactive
    hits = rng.choice([0, 1, 1, 1, 2, 5, -1, -3, 100], n)
    rare = (rng.random(n) < 0.01) & huge_hits
    hits[rare] = rng.choice([I32_MAX, I32_MIN, 2**24 + 1, -(2**24)],
                            int(rare.sum()))
    lim = rng.choice([0, 1, 5, 20, 100, 1000, -1, I32_MAX], n)
    return (kh.reshape(k, B), hits.astype(np.int32).reshape(k, B),
            lim.astype(np.int32).reshape(k, B))


def window_now(case: str, window_start: int, window_ms: int) -> int:
    """A `now` that puts a sketch whose window starts at `window_start` in
    the named case of the rotation."""
    w = window_ms
    return window_start + {
        "in_window": 0,                 # overlap exactly 1
        "sliding": (3 * w) // 5,        # overlap strictly inside (0, 1)
        "one_behind": w + w // 3,       # cur becomes prev
        "far_behind": 3 * w + 7,        # both tables clear
        "before_start": -5,             # elapsed < 0: stays, overlap 1
    }[case]


def cross_chunk_lanes(
    rng: np.random.Generator, k: int, B: int, cross: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(kh, hits, lim, lane) for a merge of k chunks of B lanes in which one
    key sits in every chunk, at lane[c] of chunk c, with 1 hit and limit
    `cross`.  On an empty sketch in its window, its estimate in chunk c is
    c, so it first goes over in chunk `cross`.  Half of the other lanes are
    inactive; the rest carry other keys with 0 hits (they read cells, add
    nothing and are never over)."""
    kh = rng.integers(I64_MIN, I64_MAX, (k, B), dtype=np.int64, endpoint=True)
    kh[(kh == 0) | (rng.random((k, B)) < 0.5)] = 0
    hits = np.zeros((k, B), np.int32)
    lim = rng.choice([0, 1, 5, I32_MAX], (k, B)).astype(np.int32)
    lane = rng.integers(0, B, k)
    rows = np.arange(k)
    kh[rows, lane] = rng.integers(1, I64_MAX, dtype=np.int64)
    hits[rows, lane] = 1
    lim[rows, lane] = cross
    return kh, hits, lim, lane


# -- the state plane -------------------------------------------------------

def random_bucket_rows(rng: np.random.Generator, ks: KeySpace,
                       table_keys: np.ndarray, B: int,
                       now: int) -> Dict[str, np.ndarray]:
    """BucketRows columns (numpy, field names of ops.step.BucketRows) for
    one upsert / inject batch of B lanes, keys unique: about a quarter are
    keys already in the table (live, expired and cached rows: the inject's
    merge lanes), four or more fresh keys in each hot (full) bucket, so a
    fourth contender finds no slot, fresh keys elsewhere, and ~10% inactive
    lanes (fingerprint 0) holding garbage.  Leaky rows carry fractional
    remaining."""
    present = np.unique(table_keys[table_keys != 0])
    cand = np.concatenate([
        rng.choice(present, min(len(present), B // 4), replace=False),
        ks.in_bucket(np.repeat(ks.hot, 5)),
        ks.in_bucket(rng.integers(0, ks.nb, B)),
    ])
    cand = cand[np.sort(np.unique(cand, return_index=True)[1])][:B]
    key = np.zeros(B, dtype=np.int64)
    key[:len(cand)] = rng.permutation(cand)
    limit = rng.choice([1, 10, 100, 2000], B).astype(np.int64)
    cols = dict(
        key_hash=key,
        algo=rng.integers(0, 2, B).astype(np.int32),
        limit=limit,
        duration=rng.choice([1000, 60_000], B).astype(np.int64),
        remaining=rng.integers(-2, 2100, B).astype(np.int64),
        remaining_f=rng.random(B) * 2100.0,
        t0=now - rng.integers(0, 100_000, B),
        status=rng.integers(0, 2, B).astype(np.int32),
        burst=rng.choice([0, 10, 2000], B).astype(np.int64),
        expire_at=now + rng.integers(1, 120_000, B),
    )
    off = rng.random(B) < 0.1
    cols["key_hash"][off] = 0
    return cols


def random_cached_block(rng: np.random.Generator, ks: KeySpace,
                        table_keys: np.ndarray, B: int,
                        now: int) -> np.ndarray:
    """int64[6, B] owner-broadcast rows in CachedRows order (the store
    kernel's block) from `random_bucket_rows`' lanes: keys already in the
    table, four or more fresh keys in each full bucket, ~10% inactive lanes
    holding garbage; half the reset times already past, so some rows land
    expired."""
    c = random_bucket_rows(rng, ks, table_keys, B, now)
    return np.stack([
        c["key_hash"], c["algo"].astype(np.int64), c["limit"],
        c["remaining"], c["status"].astype(np.int64),
        c["expire_at"] - 60_000,
    ])
