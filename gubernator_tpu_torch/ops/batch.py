"""Host-side request packing into fixed-shape rounds.

Anything data-dependent that the device step cannot do (string hashing,
Gregorian calendar math, duplicate-key rounds) happens here, on numpy.

Duplicate keys: the reference serializes same-key requests through one
worker (workers.go:182-186), so each sees the state left by the previous.
The packer therefore splits a batch into ROUNDS — occurrence 0 of every key
in round 0, occurrence 1 in round 1, ... — and the engine applies rounds in
order.  A full round overflows into the next one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from gubernator_tpu_torch.core import clock as clock_mod
from gubernator_tpu_torch.core.hashing import bulk_key_hash64
from gubernator_tpu_torch.core.interval import (
    GregorianError,
    gregorian_duration,
    gregorian_expiration,
)
from gubernator_tpu_torch.core.types import Behavior, RateLimitReq


class DeviceBatch(NamedTuple):
    """Fixed-shape [B] request lanes (the device view of RateLimitReq)."""

    key_hash: np.ndarray      # int64[B]; 0 on padding lanes
    hits: np.ndarray          # int64[B]
    limit: np.ndarray         # int64[B]
    duration: np.ndarray      # int64[B]
    algo: np.ndarray          # int32[B]
    burst: np.ndarray         # int64[B]; already defaulted to limit when 0
    reset_remaining: np.ndarray  # bool[B]
    is_greg: np.ndarray       # bool[B]
    greg_expire: np.ndarray   # int64[B]; host-precomputed interval end
    greg_duration: np.ndarray  # int64[B]; host-precomputed full interval ms
    active: np.ndarray        # bool[B]; False on padding lanes
    use_cached: np.ndarray    # bool[B]; GLOBAL read path (serve cached rows)


_BATCH_DTYPES = dict(
    key_hash=np.int64,
    hits=np.int64,
    limit=np.int64,
    duration=np.int64,
    algo=np.int32,
    burst=np.int64,
    reset_remaining=bool,
    is_greg=bool,
    greg_expire=np.int64,
    greg_duration=np.int64,
    active=bool,
    use_cached=bool,
)


@dataclass
class PackedGrid:
    """Requests packed into rounds of [n_shards, batch_size] lanes."""

    rounds: List[DeviceBatch]  # arrays are [n_shards, batch_size]
    # For each request i: (round, shard, lane); (-1, -1, -1) = errored.
    positions: List[Tuple[int, int, int]]
    errors: Dict[int, str]  # request index -> validation error


@dataclass
class PackedRounds:
    """One batch split into sequential rounds for duplicate keys."""

    rounds: List[DeviceBatch]  # arrays are [batch_size]
    # For each request i: (round_index, lane_index); (-1, -1) = errored.
    positions: List[Tuple[int, int]]
    errors: Dict[int, str]  # request index -> validation error


def empty_batch(shape) -> DeviceBatch:
    """All-inactive round of the given shape ([B] or [n_shards, B])."""
    return DeviceBatch(**{
        f: np.zeros(shape, dtype=dt) for f, dt in _BATCH_DTYPES.items()
    })


def _validate(r: RateLimitReq, now_dt, greg_bit: int):
    """(error, greg_expire, greg_duration) for one request: the checks of
    gubernator.go:228-237 (empty unique_key / name, the latter reported as
    'namespace') plus Gregorian interval validation (interval.go:107,147).
    The Gregorian fields are 0 for other requests."""
    if not r.unique_key:
        return "field 'unique_key' cannot be empty", 0, 0
    if not r.name:
        return "field 'namespace' cannot be empty", 0, 0
    if int(r.behavior) & greg_bit:
        try:
            return (None, gregorian_expiration(now_dt, r.duration),
                    gregorian_duration(now_dt, r.duration))
        except GregorianError as e:
            return str(e), 0, 0
    return None, 0, 0


def pack_requests_grid(
    reqs: Sequence[RateLimitReq],
    batch_size: int,
    n_shards: int,
    shard_fn,
    clock=None,
    use_cached: Optional[Sequence[bool]] = None,
) -> PackedGrid:
    """Pack requests into rounds of [n_shards, batch_size] lanes.

    `shard_fn(hash_key) -> int` routes each key to its owning shard (the
    worker-pool hash range / peer ring analog, workers.go:182-186).
    Validation is pack_requests'.  A key appears at most once per round,
    occurrence k of a key lands in a strictly later round than occurrence
    k-1, and a full (round, shard) overflows into the next round.

    The C++ form (native/gubtpu.cpp: round assignment over fingerprints)
    serves when the native library is loadable; the Python loop is the
    semantic reference.  The native form detects duplicates by 64-bit
    fingerprint rather than key string, which is safe: fingerprint-
    colliding keys share a slot and must be round-separated anyway."""
    from gubernator_tpu_torch import native

    if native.available():
        return _pack_requests_grid_native(
            reqs, batch_size, n_shards, shard_fn, clock, use_cached)
    return _pack_requests_grid_py(
        reqs, batch_size, n_shards, shard_fn, clock, use_cached)


def _pack_requests_grid_py(
    reqs: Sequence[RateLimitReq],
    batch_size: int,
    n_shards: int,
    shard_fn,
    clock=None,
    use_cached: Optional[Sequence[bool]] = None,
) -> PackedGrid:
    clock = clock or clock_mod.default_clock()
    now_dt = clock.now()
    greg_bit = int(Behavior.DURATION_IS_GREGORIAN)
    positions: List[Tuple[int, int, int]] = [(-1, -1, -1)] * len(reqs)
    errors: Dict[int, str] = {}
    last_round: Dict[str, int] = {}
    round_keys: List[set] = []
    per_round: List[List[list]] = []
    shard_cache: Dict[str, int] = {}
    for i, r in enumerate(reqs):
        err, ge, gd = _validate(r, now_dt, greg_bit)
        if err is not None:
            errors[i] = err
            continue
        key = r.hash_key()
        shard = shard_cache.get(key)
        if shard is None:
            shard = shard_fn(key)
            shard_cache[key] = shard
        rnd = last_round.get(key, -1) + 1
        while True:
            if rnd >= len(per_round):
                per_round.append([[] for _ in range(n_shards)])
                round_keys.append(set())
            if (len(per_round[rnd][shard]) < batch_size
                    and key not in round_keys[rnd]):
                break
            rnd += 1
        last_round[key] = rnd
        round_keys[rnd].add(key)
        per_round[rnd][shard].append((i, r, ge, gd))

    reset_bit = int(Behavior.RESET_REMAINING)
    rounds: List[DeviceBatch] = []
    for rnd_idx, shards in enumerate(per_round):
        b = empty_batch((n_shards, batch_size))
        for shard, entries in enumerate(shards):
            if entries:
                hs = bulk_key_hash64([r.hash_key() for _, r, _, _ in entries])
            for lane, (i, r, ge, gd) in enumerate(entries):
                positions[i] = (rnd_idx, shard, lane)
                at = (shard, lane)
                b.key_hash[at] = hs[lane]
                b.hits[at] = r.hits
                b.limit[at] = r.limit
                b.duration[at] = r.duration
                b.algo[at] = int(r.algorithm)
                # Burst default (algorithms.go:271-272) applied host-side.
                b.burst[at] = r.burst if r.burst != 0 else r.limit
                b.reset_remaining[at] = bool(int(r.behavior) & reset_bit)
                b.is_greg[at] = bool(int(r.behavior) & greg_bit)
                b.greg_expire[at] = ge
                b.greg_duration[at] = gd
                b.active[at] = True
                b.use_cached[at] = (
                    bool(use_cached[i]) if use_cached is not None else False)
        rounds.append(b)
    return PackedGrid(rounds=rounds, positions=positions, errors=errors)


def _pack_requests_grid_native(
    reqs: Sequence[RateLimitReq],
    batch_size: int,
    n_shards: int,
    shard_fn,
    clock=None,
    use_cached: Optional[Sequence[bool]] = None,
) -> PackedGrid:
    """Native round assignment, lane fill as numpy scatters; the same
    contract as the Python form."""
    from gubernator_tpu_torch import native

    clock = clock or clock_mod.default_clock()
    now_dt = clock.now()
    n = len(reqs)
    errors: Dict[int, str] = {}
    keys: List[str] = [""] * n
    shard_arr = np.zeros(n, dtype=np.int32) if n_shards > 1 else None
    hits = np.zeros(n, dtype=np.int64)
    limit = np.zeros(n, dtype=np.int64)
    duration = np.zeros(n, dtype=np.int64)
    algo = np.zeros(n, dtype=np.int32)
    burst = np.zeros(n, dtype=np.int64)
    reset = np.zeros(n, dtype=bool)
    is_greg = np.zeros(n, dtype=bool)
    greg_expire = np.zeros(n, dtype=np.int64)
    greg_duration = np.zeros(n, dtype=np.int64)
    greg_bit = int(Behavior.DURATION_IS_GREGORIAN)
    reset_bit = int(Behavior.RESET_REMAINING)
    shard_cache: Dict[str, int] = {}
    for i, r in enumerate(reqs):
        err, ge, gd = _validate(r, now_dt, greg_bit)
        if err is not None:
            errors[i] = err
            continue
        b = int(r.behavior)
        is_greg[i] = bool(b & greg_bit)
        greg_expire[i] = ge
        greg_duration[i] = gd
        key = r.hash_key()
        keys[i] = key
        if shard_arr is not None:
            s = shard_cache.get(key)
            if s is None:
                s = shard_fn(key)
                shard_cache[key] = s
            shard_arr[i] = s
        hits[i] = r.hits
        limit[i] = r.limit
        duration[i] = r.duration
        algo[i] = int(r.algorithm)
        burst[i] = r.burst if r.burst != 0 else r.limit
        reset[i] = bool(b & reset_bit)
    cached = (
        np.asarray(use_cached, dtype=bool) if use_cached is not None
        else np.zeros(n, dtype=bool)
    )

    hashes = np.zeros(n, dtype=np.int64)
    ok = [i for i in range(n) if i not in errors]
    if ok:
        hashes[ok] = bulk_key_hash64([keys[i] for i in ok])
    rnd, lane, n_rounds = native.assign_rounds(
        hashes, shard_arr, n_shards, batch_size)
    sh = shard_arr if shard_arr is not None else np.zeros(n, dtype=np.int32)
    positions: List[Tuple[int, int, int]] = [
        (int(rnd[i]), int(sh[i]), int(lane[i])) if rnd[i] >= 0
        else (-1, -1, -1)
        for i in range(n)
    ]
    # Group requests by round with one stable sort, not a mask scan per
    # round: duplicate-heavy batches make n_rounds ~ n.
    ok_idx = np.flatnonzero(rnd >= 0)
    order = ok_idx[np.argsort(rnd[ok_idx], kind="stable")]
    bounds = np.searchsorted(rnd[order], np.arange(n_rounds + 1))
    values = dict(
        key_hash=hashes, hits=hits, limit=limit, duration=duration,
        algo=algo, burst=burst, reset_remaining=reset, is_greg=is_greg,
        greg_expire=greg_expire, greg_duration=greg_duration,
        use_cached=cached,
    )
    rounds: List[DeviceBatch] = []
    for r_idx in range(n_rounds):
        batch = empty_batch((n_shards, batch_size))
        sel = order[bounds[r_idx]:bounds[r_idx + 1]]
        s_m, l_m = sh[sel], lane[sel]
        for f, v in values.items():
            getattr(batch, f)[s_m, l_m] = v[sel]
        batch.active[s_m, l_m] = True
        rounds.append(batch)
    return PackedGrid(rounds=rounds, positions=positions, errors=errors)


def pack_requests(
    reqs: Sequence[RateLimitReq],
    batch_size: int,
    clock=None,
    use_cached: Optional[Sequence[bool]] = None,
) -> PackedRounds:
    """Pack requests into rounds of [batch_size] lanes.

    Validation mirrors gubernator.go:228-237 (empty unique_key / name, the
    latter reported as 'namespace') plus Gregorian interval validation
    (interval.go:107,147): a failed request gets an error and no lane.
    A key appears at most once per round, and occurrence k of a key lands
    in a strictly later round than occurrence k-1.  Lanes fill from 0 in
    request order within each round.
    """
    clock = clock or clock_mod.default_clock()
    now_dt = clock.now()
    n = len(reqs)
    errors: Dict[int, str] = {}

    keys: List[str] = [""] * n
    hits = np.zeros(n, dtype=np.int64)
    limit = np.zeros(n, dtype=np.int64)
    duration = np.zeros(n, dtype=np.int64)
    algo = np.zeros(n, dtype=np.int32)
    burst = np.zeros(n, dtype=np.int64)
    reset = np.zeros(n, dtype=bool)
    is_greg = np.zeros(n, dtype=bool)
    greg_expire = np.zeros(n, dtype=np.int64)
    greg_duration = np.zeros(n, dtype=np.int64)
    rnd = np.full(n, -1, dtype=np.int64)
    lane = np.full(n, -1, dtype=np.int64)

    last_round: Dict[str, int] = {}
    round_keys: List[set] = []
    round_fill: List[int] = []
    greg_bit = int(Behavior.DURATION_IS_GREGORIAN)
    reset_bit = int(Behavior.RESET_REMAINING)
    for i, r in enumerate(reqs):
        if not r.unique_key:
            errors[i] = "field 'unique_key' cannot be empty"
            continue
        if not r.name:
            errors[i] = "field 'namespace' cannot be empty"
            continue
        b = int(r.behavior)
        if b & greg_bit:
            try:
                greg_expire[i] = gregorian_expiration(now_dt, r.duration)
                greg_duration[i] = gregorian_duration(now_dt, r.duration)
            except GregorianError as e:
                errors[i] = str(e)
                continue
            is_greg[i] = True
        key = r.hash_key()
        keys[i] = key
        k = last_round.get(key, -1) + 1
        while True:
            if k >= len(round_fill):
                round_fill.append(0)
                round_keys.append(set())
            if round_fill[k] < batch_size and key not in round_keys[k]:
                break
            k += 1
        last_round[key] = k
        round_keys[k].add(key)
        rnd[i] = k
        lane[i] = round_fill[k]
        round_fill[k] += 1
        hits[i] = r.hits
        limit[i] = r.limit
        duration[i] = r.duration
        algo[i] = int(r.algorithm)
        # Burst default (algorithms.go:271-272) applied host-side.
        burst[i] = r.burst if r.burst != 0 else r.limit
        reset[i] = bool(b & reset_bit)

    ok = np.flatnonzero(rnd >= 0)
    hashes = np.zeros(n, dtype=np.int64)
    if len(ok):
        hashes[ok] = bulk_key_hash64([keys[i] for i in ok])
    cached = (
        np.asarray(use_cached, dtype=bool) if use_cached is not None
        else np.zeros(n, dtype=bool)
    )
    values = dict(
        key_hash=hashes, hits=hits, limit=limit, duration=duration,
        algo=algo, burst=burst, reset_remaining=reset, is_greg=is_greg,
        greg_expire=greg_expire, greg_duration=greg_duration,
        use_cached=cached,
    )
    rounds: List[DeviceBatch] = []
    order = ok[np.argsort(rnd[ok], kind="stable")]
    bounds = np.searchsorted(rnd[order], np.arange(len(round_fill) + 1))
    for k in range(len(round_fill)):
        batch = empty_batch(batch_size)
        sel = order[bounds[k]:bounds[k + 1]]
        ln = lane[sel]
        for f, v in values.items():
            getattr(batch, f)[ln] = v[sel]
        batch.active[ln] = True
        rounds.append(batch)

    positions = [
        (int(rnd[i]), int(lane[i])) if rnd[i] >= 0 else (-1, -1)
        for i in range(n)
    ]
    return PackedRounds(rounds=rounds, positions=positions, errors=errors)


def pack_batch_q(db: DeviceBatch) -> np.ndarray:
    """Stack a [B] DeviceBatch into one int64[12, B] host array, or an
    [n, B] grid round into int64[12, n, B] (bools/int32 widen)."""
    q = np.empty((len(db),) + np.shape(db.key_hash), dtype=np.int64)
    for i, a in enumerate(db):
        q[i] = a
    return q
