"""TorchBackend: the single-table rate-limit engine on one torch device.

The counterpart of gubernator_tpu's `DeviceBackend` hot path (reference
WorkerPool, workers.go:56-664): one device-resident slot table; each
`check()` packs its requests into duplicate-free rounds, applies ALL of them
with ONE dispatch of the serve kernel (ops/kernels/serve_kernel.py) at the
widest batch tier the rounds need, and unpacks the packed responses.
Inactive lanes are no-ops, so the responses of active lanes do not depend on
the tier.

The device is `DeviceConfig.platform` ("cuda" when None).  Without a CUDA
device the constructor raises unless the caller asked for "cpu", where the
kernel's plain version serves.

A lock serializes host calls that touch the table, which preserves the
reference's single-writer discipline (workers.go:19-37) at whole-table
granularity.  Device work is ordered by ONE stream: the backend keeps the
stream that was current when it was built and issues every kernel, copy and
event on it, whatever thread calls (the service's device executor, the fast
lane's pool, the ring runner).  The device, the stream and every crossing
to and from the card are the backend's `place` (runtime/place.py
`DevicePlace`): pinned uploads, and fetches behind their own events, so a
fetch waits for its own dispatch only, never for launches queued after it.

The ring protocol (runtime/ring.py) and the persistent serve mode dispatch
the same kernel: on the card every serve mode runs K1.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.core import clock as clock_mod
from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.core.hashing import bulk_key_hash64, key_hash64
from gubernator_tpu_torch.core.types import (
    Algorithm,
    CacheItem,
    RateLimitReq,
    RateLimitResp,
    Status,
)
from gubernator_tpu_torch.ops.batch import DeviceBatch, pack_batch_q, pack_requests
from gubernator_tpu_torch.ops.kernels import serve_kernel
from gubernator_tpu_torch.ops.kernels.serve_kernel import persistent_serve_step
from gubernator_tpu_torch.ops.state import (
    COLUMN_DTYPES,
    KIND_CACHED_RESP,
    SlotTable,
    TableStats,
    demote_extract,
    init_table,
    migrate_extract,
    migrate_inject,
    table_from_host,
    table_stats,
)
from gubernator_tpu_torch.ops.step import (
    GATHER_ROW_FIELDS,
    RESP_ROWS,
    BucketRows,
    gather_rows,
    load_rows,
    probe_batch,
)
from gubernator_tpu_torch.runtime.place import DevicePlace, PendingFetch
from gubernator_tpu_torch.runtime.tracing import stage_begin, stage_end


def resolve_tiers(cfg: DeviceConfig) -> Tuple[int, ...]:
    """Sorted batch tiers; batch_size is always included so tier_of's
    fallback never truncates a full round."""
    tiers = cfg.batch_tiers or (128, cfg.batch_size)
    return tuple(sorted(
        {min(t, cfg.batch_size) for t in tiers} | {cfg.batch_size}
    ))


def tier_of(active: np.ndarray, tiers: Sequence[int]) -> int:
    """Smallest tier that holds this round's active lanes (the packer fills
    lanes contiguously from 0, so the count bounds the highest used lane)."""
    occ = int(np.asarray(active).sum(-1).max())
    for t in tiers:
        if occ <= t:
            return t
    return tiers[-1]


def rounds_to_qs(
    rounds: Sequence[DeviceBatch], tiers: Sequence[int]
) -> np.ndarray:
    """Stack rounds into one int64[k, 12, t] block (int64[k, 12, n, t] for
    [n, B] grid rounds) at the widest tier any of them needs."""
    t = max(tier_of(db.active, tiers) for db in rounds)
    return np.stack([pack_batch_q(db)[..., :t] for db in rounds])


# Occupied lanes cross to the card in whole multiples of this many.
SEND_ALIGN = 128


def occupied_q(
    rounds: Sequence[DeviceBatch], tiers: Sequence[int]
) -> np.ndarray:
    """Stack the lanes of [B] rounds that carry requests into one
    int64[k, 12, a] block: a is the highest active lane + 1 over the
    rounds, rounded up to a multiple of SEND_ALIGN and never wider than
    the tier `rounds_to_qs` stacks at.  Each column is written once,
    straight into the block."""
    t = max(tier_of(db.active, tiers) for db in rounds)
    hi = 0
    for db in rounds:
        lanes = np.flatnonzero(db.active)
        if lanes.size:
            hi = max(hi, int(lanes[-1]) + 1)
    a = min(t, max(1, -(-hi // SEND_ALIGN)) * SEND_ALIGN)
    q = np.empty((len(rounds), len(rounds[0]), a), dtype=np.int64)
    for j, db in enumerate(rounds):
        for i, col in enumerate(db):
            q[j, i] = col[:a]
    return q


class Tally(NamedTuple):
    """Per-call metric increments (gubernator.go:59-113 counters)."""

    checks: int
    over_limit: int
    not_persisted: int
    cache_hits: int = 0


def _packed_resp_dict(a: np.ndarray) -> Dict[str, np.ndarray]:
    """[9, B] packed response (or [n, 9, B], a shard grid's) -> named host
    columns ([B] or [n, B])."""
    return {f: a[..., i, :] for i, f in enumerate(RESP_ROWS)}


def packed_rounds_to_host(resps) -> List[Dict[str, np.ndarray]]:
    """int64[k, 9, B] responses (int64[k, n, 9, B] on a shard grid) ->
    per-round host dicts, in ONE
    device-to-host copy.  `resps` is a device tensor (a blocking copy) or
    a PendingFetch of one (waits on its own event)."""
    if isinstance(resps, PendingFetch):
        host = resps.wait()[0]
    else:
        host = resps.cpu().numpy()
    return [_packed_resp_dict(a) for a in host]


def tally_from_rounds(rounds, round_host) -> Tally:
    """Vectorized Tally over packed rounds (active lanes only)."""
    checks = over = notp = hits = 0
    for db, h in zip(rounds, round_host):
        act = np.asarray(db.active)[..., : h["status"].shape[-1]]
        checks += int(act.sum())
        over += int(((h["status"] == 1) & act).sum())
        notp += int(((h["persisted"] == 0) & act).sum())
        hits += int(((h["found"] != 0) & act).sum())
    return Tally(checks, over, notp, hits)


def unmarshal_responses(
    n_reqs: int,
    errors: Dict[int, str],
    positions: Sequence[tuple],
    round_host: List[Dict[str, np.ndarray]],
) -> Tuple[List[RateLimitResp], Tally]:
    """Per-request RateLimitResp from packed positions: (round, lane), or
    (round, shard, lane) on a shard grid.

    The requested lanes are gathered with one numpy index per column
    first, so only they are converted to Python ints."""
    width = len(positions[0]) if n_reqs else 2
    pos = np.asarray(positions, dtype=np.int64).reshape(n_reqs, width)
    ok = np.flatnonzero(pos[:, 0] >= 0)
    at = tuple(pos[ok].T)
    cols = {}
    for f in ("status", "limit", "remaining", "reset_time", "persisted",
              "found"):
        v = np.stack([r[f] for r in round_host])[at] \
            if len(ok) else np.zeros(0, dtype=np.int64)
        cols[f] = v
    status = cols["status"].tolist()
    limit = cols["limit"].tolist()
    remaining = cols["remaining"].tolist()
    reset_time = cols["reset_time"].tolist()
    out: List[RateLimitResp] = []
    j = 0
    for i in range(n_reqs):
        err = errors.get(i)
        if err is not None:
            out.append(RateLimitResp(error=err))
            continue
        out.append(RateLimitResp(
            status=Status(status[j]),
            limit=limit[j],
            remaining=remaining[j],
            reset_time=reset_time[j],
        ))
        j += 1
    tally = Tally(
        checks=len(ok),
        over_limit=int((cols["status"] == Status.OVER_LIMIT).sum()),
        not_persisted=int((cols["persisted"] == 0).sum()),
        cache_hits=int((cols["found"] != 0).sum()),
    )
    return out, tally


# Host dtypes of the BucketRows columns.
_ROW_DTYPES = {f: np.int64 for f in BucketRows._fields}
_ROW_DTYPES.update(algo=np.int32, status=np.int32, remaining_f=np.float64)


def probe_bucket(
    rows: Dict[str, np.ndarray],
    ways: int,
    key: str,
    now: int,
    include_cached: bool = True,
) -> Optional[CacheItem]:
    """The live item for `key` among one bucket's host rows, if any (the
    WorkerPool.GetCacheItem analog, workers.go:614-646; expired rows read
    as misses like lrucache.go:115-127).  With include_cached=False a
    GLOBAL broadcast row (KIND_CACHED_RESP) reads as a miss."""
    h = int(np.uint64(key_hash64(key)).view(np.int64))
    for w in range(ways):
        if rows["key"][w] == h and rows["expire_at"][w] > now:
            if not include_cached and rows["kind"][w] == KIND_CACHED_RESP:
                return None
            return _row_to_item(rows, w, key)
    return None


def _row_to_item(snap: Dict[str, np.ndarray], s: int, key: str) -> CacheItem:
    algo = Algorithm(int(snap["algo"][s]))
    remaining: float
    if algo == Algorithm.LEAKY_BUCKET:
        remaining = float(snap["remaining_f"][s])
    else:
        remaining = int(snap["remaining"][s])
    return CacheItem(
        key=key,
        algorithm=algo,
        expire_at=int(snap["expire_at"][s]),
        limit=int(snap["limit"][s]),
        duration=int(snap["duration"][s]),
        remaining=remaining,
        created_at=int(snap["t0"][s]),
        status=Status(int(snap["status"][s])),
        burst=int(snap["burst"][s]),
    )


def _h64s(hashes: Sequence[int]) -> np.ndarray:
    """Unsigned 64-bit key fingerprints -> the int64 view stored on device."""
    return np.array(hashes, dtype=np.uint64).view(np.int64)


def _u64(fp) -> int:
    """int64 table fingerprint -> the unsigned int the keymap is keyed by."""
    return int(np.int64(fp).view(np.uint64))


class PersistenceHost:
    """Host-side Store/Loader plumbing (the SPI semantics of
    store.go:49-78 / workers.go:340-530), as in the JAX package.

    The backend provides the device hooks `_found_mask(keys, hashes, now)`
    (bool residency per unsigned hash; caller holds `_lock`),
    `_bulk_upsert(rows, hashes, now)` (caller holds `_lock`),
    `_gather_rows_dispatch(h64, now)` / `_gather_rows_finish(token, m)`,
    `_read_items_locked(keys)`, `_columns_fetch(fields)`, `key_column()`
    and `snapshot()`, plus the attributes `cfg`, `clock`, `store`,
    `_keymap` and `_lock`."""

    def _maybe_prune_keymap(self) -> None:
        """Bound the fingerprint->key map: the table holds at most
        num_slots live rows, so once the map is 4x that, drop fingerprints
        no longer resident.  The rebuild holds `_keymap_lock`: the object
        path's executor, the fast-lane pool and the ring runner all write
        the map concurrently."""
        assert self._keymap is not None
        if len(self._keymap) <= max(4 * self.cfg.num_slots, 65_536):
            return
        resident = set(self.key_column().view(np.uint64).tolist())
        with self._keymap_lock:
            self._keymap = {
                fp: k for fp, k in self._keymap.items() if fp in resident
            }

    def _seed_from_store(self, reqs, packed, now: int) -> None:
        """Consult Store.get for batch keys not resident on device and bulk
        upsert the hits (the batched analog of algorithms.go:45-51).
        Caller holds `_lock`."""
        uniq: Dict[str, RateLimitReq] = {}
        for i, r in enumerate(reqs):
            if i not in packed.errors:
                uniq.setdefault(r.hash_key(), r)
        keys = list(uniq.keys())
        if not keys:
            return
        hashes = [key_hash64(k) for k in keys]
        found = self._found_mask(keys, hashes, now)
        self._store_seed_misses(hashes, [uniq[k] for k in keys], found, now)

    def _store_seed_misses(self, hashes, reqs, found, now: int):
        """Store-consult core shared by the object path (probe-derived
        `found`) and the fast lane's cold-key repair (the step's own
        `found` column): Store.get for each miss, one bulk upsert of the
        live items.  Caller holds `_lock`.  Returns the indices (into the
        input lists) that were seeded."""
        from gubernator_tpu_torch.runtime.store import item_to_row_fields

        rows: List[dict] = []
        row_hashes: List[int] = []
        seeded: List[int] = []
        for i, (h, r, f) in enumerate(zip(hashes, reqs, found)):
            if f:
                continue
            item = self.store.get(r)
            if item is None or item.is_expired(now):
                continue
            rows.append(item_to_row_fields(item))
            row_hashes.append(h)
            seeded.append(i)
        if rows:
            self._bulk_upsert(rows, row_hashes, now)
        return seeded

    def _init_write_through(self) -> None:
        """Write-through delivery ordering + keymap-writer state."""
        self._wt_seq = 0
        self._wt_next = 0
        self._wt_cond = threading.Condition()
        self._keymap_lock = threading.Lock()

    def _wt_ticket(self) -> int:
        """Next write-through delivery ticket (caller holds `_lock`).
        Tickets order Store.on_change delivery across concurrent batches:
        without them a slower thread could deliver an OLDER captured state
        after a newer one and the store would diverge from the table (the
        reference orders delivery by calling OnChange inside the per-key
        worker).  Every ticket MUST be redeemed via _deliver_write_through
        (even with an empty capture) or later deliveries stall."""
        seq = self._wt_seq
        self._wt_seq = seq + 1
        return seq

    def _capture_write_through(
        self, reqs, packed, use_cached=None
    ) -> List[Tuple[RateLimitReq, CacheItem]]:
        """Read back post-step rows for persisted requests while the caller
        STILL HOLDS `_lock` (the reference calls OnChange synchronously
        inside the algorithm, algorithms.go:154-158).  Lanes served from
        the GLOBAL broadcast cache (use_cached) are excluded: their rows
        are replicated responses, not authoritative bucket state."""
        seen: set = set()
        key_req: List[Tuple[str, RateLimitReq]] = []
        for i, r in enumerate(reqs):
            if i in packed.errors:
                continue
            if use_cached is not None and use_cached[i]:
                continue
            key = r.hash_key()
            if key in seen:
                continue
            seen.add(key)
            key_req.append((key, r))
        if not key_req:
            return []
        items = self._read_items_locked([k for k, _ in key_req])
        return [(r, items[k]) for k, r in key_req if k in items]

    def _deliver_write_through(self, captured, seq: int) -> None:
        """Hand captured post-step items to Store.on_change in capture
        order (`seq` from `_wt_ticket`).  Runs OUTSIDE `_lock` (on_change
        is user code), but a FIFO ticket wait preserves step order."""
        cond = self._wt_cond
        with cond:
            while self._wt_next != seq:
                cond.wait()
        try:
            for r, item in captured:
                self.store.on_change(r, item)
        finally:
            with cond:
                self._wt_next += 1
                cond.notify_all()

    def _note_keys(self, keys: Sequence[str]) -> None:
        """Record fingerprint -> key for `keys` (key tracking only)."""
        if self._keymap is None or not keys:
            return
        hs = bulk_key_hash64(list(keys)).view(np.uint64).tolist()
        with self._keymap_lock:
            km = self._keymap
            for h, k in zip(hs, keys):
                km[h] = k

    # -- live slot migration (runtime/reshard.py) ------------------------
    def key_snapshot(self):
        """(key int64[S], kind int32[S], expire_at int64[S]) host copies:
        the reshard plane's remap-delta input (three columns, not the
        whole table)."""
        return tuple(
            self._columns_fetch(("key", "kind", "expire_at")).wait())

    def migrate_extract_rows(self, fps: np.ndarray):
        """Atomically gather-and-clear the rows for int64 fingerprints
        `fps`: returns (int64[10, n] in GATHER_ROW_FIELDS order, packed[0]
        the found mask, float64[n] remaining_f).  Cleared rows read as
        empty to every probe from the moment the lock releases.

        The generic path (the mesh backend): a row gather plus an
        expire_at=0 re-upsert in ONE critical section, two dispatches
        with the same atomicity, over the backend's gather and upsert."""
        n = len(fps)
        now = self.clock.millisecond_now()
        with self._lock:
            token = self._gather_rows_dispatch(
                np.asarray(fps, dtype=np.int64), now)
            packed, rf = self._gather_rows_finish(token, n)
            hit = np.flatnonzero(packed[0] != 0)
            if len(hit):
                rows = [
                    {
                        "algo": int(packed[2][j]),
                        "limit": int(packed[3][j]),
                        "duration": int(packed[4][j]),
                        "remaining": int(packed[5][j]),
                        "remaining_f": float(rf[j]),
                        "t0": int(packed[6][j]),
                        "status": int(packed[7][j]),
                        "burst": int(packed[8][j]),
                        "expire_at": 0,  # the clear
                    }
                    for j in hit
                ]
                self._bulk_upsert(rows, [_u64(fps[j]) for j in hit], now)
        return packed, rf

    def migrate_inject_rows(self, cols: Dict[str, np.ndarray]):
        """Upsert migrated row columns (BucketRows field names) where the
        key is absent; MERGE where it is resident: subtract the migrated
        row's consumed budget from the resident row, clamped at 0 (counters
        conserved, never inflated).  Returns (injected, merged).

        The generic path (the mesh backend): probe + upsert + a gather /
        re-upsert merge in one critical section."""
        n = len(cols["key_hash"])
        now = self.clock.millisecond_now()
        h64 = np.asarray(cols["key_hash"], dtype=np.int64)
        hashes_u = [_u64(h) for h in h64]
        with self._lock:
            found = np.asarray(self._found_mask([""] * n, hashes_u, now))
            absent = np.flatnonzero(~found)
            if len(absent):
                self._bulk_upsert(
                    [
                        {
                            "algo": int(cols["algo"][j]),
                            "limit": int(cols["limit"][j]),
                            "duration": int(cols["duration"][j]),
                            "remaining": int(cols["remaining"][j]),
                            "remaining_f": float(cols["remaining_f"][j]),
                            "t0": int(cols["t0"][j]),
                            "status": int(cols["status"][j]),
                            "burst": int(cols["burst"][j]),
                            "expire_at": int(cols["expire_at"][j]),
                        }
                        for j in absent
                    ],
                    [hashes_u[j] for j in absent], now,
                )
            idx = np.flatnonzero(found)
            if len(idx):
                packed, rf = self._gather_rows_finish(
                    self._gather_rows_dispatch(h64[idx], now), len(idx))
                rows = []
                for k, j in enumerate(idx):
                    consumed_i = max(
                        int(cols["limit"][j]) - int(cols["remaining"][j]), 0)
                    consumed_f = max(
                        float(cols["limit"][j])
                        - float(cols["remaining_f"][j]), 0.0)
                    leaky = int(cols["algo"][j]) == 1
                    rows.append({
                        # The RESIDENT row's fields, with the migrated
                        # consumption folded in.
                        "algo": int(packed[2][k]),
                        "limit": int(packed[3][k]),
                        "duration": int(packed[4][k]),
                        "remaining": max(
                            int(packed[5][k])
                            - (0 if leaky else consumed_i), 0),
                        "remaining_f": max(
                            float(rf[k]) - (consumed_f if leaky else 0.0),
                            0.0),
                        "t0": int(packed[6][k]),
                        "status": int(packed[7][k]),
                        "burst": int(packed[8][k]),
                        "expire_at": int(packed[9][k]),
                    })
                self._bulk_upsert(rows, [hashes_u[j] for j in idx], now)
        injected = len(absent)
        return injected, n - injected

    def load_items(self, items) -> int:
        """Bulk upsert CacheItems (Loader restore, workers.go:340-426)."""
        from gubernator_tpu_torch.runtime.store import item_to_row_fields

        chunk = 4 * self.cfg.batch_size
        now = self.clock.millisecond_now()
        n = 0
        rows: List[dict] = []
        hashes: List[int] = []
        for item in items:
            h = key_hash64(item.key)
            if self._keymap is not None:
                with self._keymap_lock:
                    self._keymap[h] = item.key
            rows.append(item_to_row_fields(item))
            hashes.append(h)
            n += 1
            if len(rows) >= chunk:
                with self._lock:
                    self._bulk_upsert(rows, hashes, now)
                rows, hashes = [], []
        if rows:
            with self._lock:
                self._bulk_upsert(rows, hashes, now)
        return n

    def live_items(self) -> List[CacheItem]:
        """All live rows as CacheItems (Loader save, workers.go:467-530).
        Requires key tracking (a Store/Loader attached at construction).
        KIND_CACHED_RESP rows are replicated GLOBAL broadcast responses,
        not bucket state: saving them would resurrect them as owner
        buckets on restore."""
        if self._keymap is None:
            raise RuntimeError(
                "live_items() needs key tracking; construct the backend "
                "with a store or track_keys=True"
            )
        snap = self.snapshot()
        now = self.clock.millisecond_now()
        live = np.flatnonzero(
            (snap["key"] != 0)
            & (snap["expire_at"] > now)
            & (snap["kind"] != KIND_CACHED_RESP)
        )
        out: List[CacheItem] = []
        for s in live:
            key = self._keymap.get(_u64(snap["key"][s]))
            if key is None:
                continue
            out.append(_row_to_item(snap, s, key))
        return out


class TorchDeviceHost(PersistenceHost):
    """What every torch engine shares: its common state (`_init_host`),
    the tallies, fetches of a dispatch's results and whole-table copies.
    The single-table TorchBackend and the sharded
    parallel/sharded.MeshBackend build on it."""

    # The sequence number of the latest dispatch (`_lock` held): the
    # `call` of its stages (runtime/tracing.py), which its fetch reuses.
    _call = 0

    def _init_host(self, cfg: DeviceConfig, clock, metrics, store,
                   track_keys: bool, place: DevicePlace) -> None:
        """The state every torch engine shares: its config, clock and
        metrics, the Store write-through and the fingerprint -> key map
        that persistence needs to name device rows, the lock, the
        counters, the batch tiers, and `place`: the device and the one
        stream every launch, copy and event of the table goes on (a
        mesh's: its first shard's device and that card's current stream,
        which the sketch lane shares; no shard op uses it)."""
        self.cfg = cfg
        # Any object with millisecond_now() and now() will do.
        self.clock = clock or clock_mod.default_clock()
        self.metrics = metrics
        self.store = store
        self._keymap: Optional[Dict[int, str]] = (
            {} if (store is not None or track_keys) else None
        )
        self._init_write_through()
        # Seconds the last bulk table copy (snapshot, key column) held
        # `_lock`: serving waits that long.
        self.last_copy_lock_s = 0.0
        self._lock = threading.Lock()
        self.place = place
        self.device, self.stream = place.device, place.stream
        self._tiers = resolve_tiers(cfg)
        self.checks = 0
        self.over_limit = 0
        self.not_persisted = 0

    def _add_tally(self, tally: Tally) -> None:
        with self._lock:
            self.checks += tally.checks
            self.over_limit += tally.over_limit
            self.not_persisted += tally.not_persisted
        m = self.metrics
        if m is not None:
            m.check_counter.inc(tally.checks)
            if tally.over_limit:
                m.over_limit_counter.inc(tally.over_limit)
            if tally.not_persisted:
                m.unexpired_evictions.inc(tally.not_persisted)
            m.cache_access_count.labels(type="hit").inc(tally.cache_hits)
            m.cache_access_count.labels(type="miss").inc(
                tally.checks - tally.cache_hits
            )

    def _observe_step(self, t_start: float) -> None:
        if self.metrics is not None:
            self.metrics.device_step_duration.observe(
                time.monotonic() - t_start
            )

    def _fetch_later(self, *tensors: torch.Tensor) -> PendingFetch:
        """Start copying `tensors` to the host behind their own event;
        caller holds `_lock`, right after the dispatch that made them.
        Only what `tensors` hold is copied: a TorchBackend dispatch's
        responses are its occupied lanes alone (`occupied_q`)."""
        with self.place.on_stream():
            return self.place.fetch(tensors)

    # -- state -----------------------------------------------------------
    def _columns_fetch(self, fields: Sequence[str], lo: int = 0,
                       n: Optional[int] = None) -> PendingFetch:
        """Start copying table columns [lo, lo + n) to the host.  The host
        buffers (pinned on the card) are allocated before the lock is
        taken, so `_lock` is held only while the copies are queued on the
        backend's stream: they read the columns at that point of the
        stream, and launches queued later cannot change what they copy.
        On the CPU the copy itself runs under the lock."""
        n = self.cfg.num_slots - lo if n is None else n
        host = [self.place.host_buffer(n, COLUMN_DTYPES[f]) for f in fields]
        t0 = time.monotonic()
        with self._lock, self.place.on_stream():
            pending = self.place.fetch(
                [getattr(self.table, f)[lo:lo + n] for f in fields], host)
        self.last_copy_lock_s = time.monotonic() - t0
        return pending

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Copy the whole table to the host, in the snapshot dict format of
        gubernator_tpu's DeviceBackend (the Loader-save and checkpoint
        path)."""
        fields = SlotTable._fields
        return dict(zip(fields, self._columns_fetch(fields).wait()))

    def key_column(self) -> np.ndarray:
        """Host copy of the fingerprint column (the keymap prune)."""
        return self._columns_fetch(("key",)).wait()[0]

    def _install_table(self, arrays: Dict[str, np.ndarray]) -> None:
        """Replace the live table from host arrays (snapshot format)."""
        if arrays["key"].shape[0] != self.cfg.num_slots:
            raise ValueError(
                f"snapshot has {arrays['key'].shape[0]} slots, backend "
                f"expects {self.cfg.num_slots}"
            )
        with self._lock, self.place.on_stream():
            self.table = table_from_host(arrays, self.device)

    def occupancy(self) -> int:
        with self._lock, self.place.on_stream():
            return int(self.table.occupancy())

    def occupancy_dispatch(self):
        """Dispatch the resident-slot count under the lock; the returned
        closure fetches it (the tier manager's watermark read)."""
        with self._lock, self.place.on_stream():
            pending = self.place.fetch([self.table.occupancy()])
        return lambda: int(pending.wait()[0])

    # -- hot path --------------------------------------------------------
    def check(
        self,
        reqs: Sequence[RateLimitReq],
        use_cached: Optional[Sequence[bool]] = None,
    ) -> List[RateLimitResp]:
        """Apply a list of checks; returns responses in request order.

        Duplicate keys go to sequential rounds, so same-key requests
        observe each other's effects (workers.go:182-186).  `use_cached[i]`
        marks request i to serve a live GLOBAL broadcast row verbatim
        (gubernator.go:434-447).
        """
        packed = self._pack(reqs, use_cached)
        now = self.clock.millisecond_now()
        if self._keymap is not None:
            self._note_keys([
                r.hash_key() for i, r in enumerate(reqs)
                if i not in packed.errors
            ])
            self._maybe_prune_keymap()
        round_host: List[Dict[str, np.ndarray]] = []
        captured = None
        t_start = time.monotonic()
        pending = None
        with self._lock:
            if self.store is not None:
                self._seed_from_store(reqs, packed, now)
            if packed.rounds:
                pending = self._fetch_later(
                    self._dispatch_rounds_locked(packed.rounds))
            if self.store is not None:
                # Read-back inside the lock: a concurrent batch must not
                # mutate a key between this batch's step and on_change.
                captured = self._capture_write_through(
                    reqs, packed, use_cached)
                wt_seq = self._wt_ticket()
        try:
            if pending is not None:
                round_host = packed_rounds_to_host(pending)
        finally:
            # The ticket MUST be redeemed even if the fetch fails (the
            # step already happened, so delivering the capture is right).
            if captured is not None:
                self._deliver_write_through(captured, wt_seq)
        step_s = time.monotonic() - t_start
        if self.metrics is not None:
            self.metrics.device_step_duration.observe(step_s)
            self.metrics.pool_queue_length.observe(len(reqs))
        out, tally = unmarshal_responses(
            len(reqs), packed.errors, packed.positions, round_host
        )
        self._add_tally(tally)
        fr = getattr(self.metrics, "flightrec", None)
        if fr is not None:
            fr.record_batch(
                len(reqs), step_s * 1e3,
                over_limit=tally.over_limit,
                errors=len(packed.errors),
            )
        return out

    def step_rounds(
        self, rounds: Sequence[DeviceBatch], add_tally: bool = True
    ) -> List[Dict[str, np.ndarray]]:
        """Columnar hot path: apply pre-packed rounds ([B], or [n, B] on a
        shard grid); returns host response dicts per round, as wide as
        the lanes the rounds occupy, rounded up to 128 and at most the
        tier (`occupied_q`; a shard grid's at the launch's tier width)."""
        return self.step_rounds_begin(rounds, add_tally)()

    def step_rounds_begin(
        self, rounds: Sequence[DeviceBatch], add_tally: bool = True
    ):
        """Dispatch the rounds under the lock and return a zero-arg fetch
        closure producing the host response dicts.  The closure waits on
        this dispatch's own copy event, so it may run while later launches
        go out (the pipelined drain)."""
        t_start = time.monotonic()
        pending = None
        call = 0
        if rounds:
            with self._lock:
                resps = self._dispatch_rounds_locked(rounds)
                call = self._call
                t = stage_begin()
                pending = self._fetch_later(resps)
                stage_end("exact.stage", call, t)

        def fetch() -> List[Dict[str, np.ndarray]]:
            if pending is None:
                return []
            t = stage_begin()
            block = pending.wait()[0]
            stage_end("exact.wait", call, t)
            t = stage_begin()
            host = [_packed_resp_dict(a) for a in block]
            if add_tally:
                tally = tally_from_rounds(rounds, host)
                self._add_tally(tally)
                fr = getattr(self.metrics, "flightrec", None)
                if fr is not None:
                    fr.record_batch(
                        tally.checks, (time.monotonic() - t_start) * 1e3,
                        over_limit=tally.over_limit,
                    )
            stage_end("exact.tally", call, t)
            return host

        return fetch

    def _pack_rounds(self, rounds) -> np.ndarray:
        """The request block of `rounds` as it crosses to the card: here
        the whole tier (`rounds_to_qs`)."""
        return rounds_to_qs(rounds, self._tiers)

    def _dispatch_rounds_locked(self, rounds) -> torch.Tensor:
        """Launch the serve kernel once for all `rounds` (once a shard on a
        shard grid) as the next call (`_call`); caller holds `_lock`.
        Returns the un-synced int64[k, 9, w] responses (int64[k, n, 9, w]
        on a grid), w the width of `_pack_rounds`' block."""
        t_start = time.monotonic()
        now = self.clock.millisecond_now()
        self._call += 1
        t = stage_begin()
        qs = self._pack_rounds(rounds)
        nows = np.full(len(rounds), now, dtype=np.int64)
        if t:
            # Lanes shipped (k rounds at the block's width, shards
            # included) and lanes that carry a request.
            stage_end("exact.pack", self._call, t, {
                "lanes": qs.size // qs.shape[1],
                "active": sum(int(np.count_nonzero(db.active))
                              for db in rounds)})
        resps, _ = self._launch(qs, nows, 0)
        self._observe_step(t_start)
        return resps

    # -- ring drain discipline (runtime/ring.py) -------------------------
    def ring_supported(self) -> bool:
        """The ring runner stacks [12, B] rounds along a leading slot axis
        and this backend dispatches such blocks with K1."""
        return True

    def ring_pack_round(self, db, tb: int) -> np.ndarray:
        """One round -> its ring slot layout: [12, tb], or [12, n, tb] for
        an [n, B] grid round."""
        return pack_batch_q(db)[..., :tb]

    def ring_step_dispatch(self, qs, nows, seq, fetch: bool = False):
        """Drain `qs` int64[k, 12, B] stacked rounds in ONE kernel dispatch
        under the lock (int64[k, 12, n, B] on a shard grid, one dispatch a
        shard).  Returns (responses[k, 9, B], seq + k), the
        responses un-synced on the device (the JAX backend's contract); with
        `fetch` (the ring runner), a PendingFetch of (responses, seq + k)
        started right after the dispatch in their place.  The word is a
        fresh tensor per dispatch, never updated in place, so an
        iteration's own word stays readable after the next dispatch takes
        it as input."""
        t_start = time.monotonic()
        with self._lock:
            self._call += 1
            resps, seq = self._launch(qs, nows, seq)
            out = self._fetch_later(resps, seq) if fetch else resps
        self._observe_step(t_start)
        return out, seq

    def ring_mega_dispatch(self, qs, nows, seq, fetch: bool = False):
        """One megaround iteration: `qs` int64[r, s, 12, B] applied in
        order as r*s rounds in ONE dispatch (megaround is a sequential
        scan of rounds).  Returns (responses[r, s, 9, B], seq + r*s), or
        with `fetch` a PendingFetch of the flat [r*s, 9, B] responses and
        the word."""
        r, s = qs.shape[0], qs.shape[1]
        out, seq = self.ring_step_dispatch(
            qs.reshape((r * s,) + tuple(qs.shape[2:])), nows.reshape(r * s),
            seq, fetch=fetch)
        if not fetch:
            out = out.unflatten(0, (r, s))
        return out, seq

    def read_items_bulk(
        self, keys: Sequence[str], include_cached: bool = False
    ) -> Dict[str, CacheItem]:
        """Batched point reads: probe + row gather in batch_size chunks,
        one host fetch.  KIND_CACHED_RESP rows (the GLOBAL broadcast
        cache, not bucket state) are skipped unless asked for."""
        with self._lock:
            return self._read_items_locked(keys, include_cached)

    def _read_items_locked(
        self, keys: Sequence[str], include_cached: bool = False
    ) -> Dict[str, CacheItem]:
        """read_items_bulk body; caller holds `_lock` (write-through
        capture reads back rows in the same critical section as the
        step)."""
        if not keys:
            return {}
        now = self.clock.millisecond_now()
        hashes = bulk_key_hash64(list(keys))
        packed, rf = self._gather_rows_finish(
            self._gather_rows_dispatch(hashes, now), len(keys))
        rows = {f: packed[i] for i, f in enumerate(GATHER_ROW_FIELDS)}
        rows["remaining_f"] = rf
        out: Dict[str, CacheItem] = {}
        for j, k in enumerate(keys):
            if not rows["found"][j]:
                continue
            if rows["kind"][j] == KIND_CACHED_RESP and not include_cached:
                continue
            out[k] = _row_to_item(rows, j, k)
        return out

    def get_cache_item(self, key: str) -> Optional[CacheItem]:
        """Point read of one key; copies only the key's bucket (`ways`
        slots), not the whole table."""
        ways = self.cfg.ways
        now = self.clock.millisecond_now()
        fields = SlotTable._fields
        rows = dict(zip(fields, self._columns_fetch(
            fields, self.bucket_offset(key), ways).wait()))
        return probe_bucket(rows, ways, key, now)


class TorchBackend(TorchDeviceHost):
    """Single-table rate-limit engine on one torch device."""

    def __init__(
        self,
        cfg: Optional[DeviceConfig] = None,
        clock=None,
        metrics=None,
        store=None,
        track_keys: bool = False,
    ) -> None:
        cfg = cfg or DeviceConfig()
        self._init_host(cfg, clock, metrics, store, track_keys,
                        DevicePlace.resolve(cfg.device, type(self).__name__))
        with self.place.on_stream():
            self.table: SlotTable = init_table(
                self.cfg.num_slots, self.device
            )
        # The serve kernel's claim words: all INT32_MAX between launches.
        self.claim = self.place.claim_words(self.cfg.num_slots)

    def _launch(self, qs, nows, seq) -> Tuple[torch.Tensor, torch.Tensor]:
        """One serve-kernel dispatch on the backend's stream; caller holds
        `_lock`.  Returns the un-synced (int64[k, 9, B], seq + k)."""
        with self.place.on_stream():
            t = stage_begin()
            qs = self.place.upload(qs).contiguous()
            nows = self.place.upload(nows).contiguous()
            if not isinstance(seq, torch.Tensor):
                seq = np.asarray(seq, dtype=np.int64)
            seq = self.place.upload(seq)
            stage_end("exact.stage", self._call, t)
            t = stage_begin()
            self.table, resps, seq = persistent_serve_step(
                self.table, qs, nows, seq, ways=self.cfg.ways,
                claim=self.claim,
                scratch=self.place.scratch_for(qs.shape[0], qs.shape[2]),
            )
            stage_end("exact.launch", self._call, t)
        return resps, seq

    def _pack_rounds(self, rounds) -> np.ndarray:
        """Only the lanes the rounds occupy (`occupied_q`): K1 takes any
        width and compiles nothing per shape, so it walks those alone."""
        return occupied_q(rounds, self._tiers)

    def _pack(self, reqs, use_cached=None):
        return pack_requests(reqs, self.cfg.batch_size, self.clock, use_cached)

    def bucket_offset(self, key: str) -> int:
        """Row index of `key`'s bucket."""
        nb = self.cfg.num_slots // self.cfg.ways
        return (key_hash64(key) & (nb - 1)) * self.cfg.ways

    # -- ring drain discipline (runtime/ring.py) -------------------------
    def ring_q_shape(self, tb: int) -> tuple:
        """Per-round request-slot shape at batch tier `tb`: [12, tb]."""
        return (12, tb)

    def ring_seq_init(self) -> torch.Tensor:
        """A fresh device-resident ring sequence word."""
        with self.place.on_stream():
            return torch.zeros((), dtype=torch.int64, device=self.device)

    persistent_serve_dispatch = TorchDeviceHost.ring_step_dispatch

    def persistent_serve_supported(self):
        """(ok, reason) for GUBER_SERVE_MODE=persistent.  On the card:
        K1's real build (nvcc at first use) and its owner-block count; a
        failed build raises.  On the CPU there is no kernel to arm, and the
        fast lane degrades to megaround, as the JAX package does where its
        kernel cannot compile."""
        if self.stream is None:
            return False, (
                f"no serve kernel on {self.device.type}: the persistent "
                "mode needs the CUDA kernel (csrc/serve_kernel.cu)"
            )
        serve_kernel.library()
        return True, (
            f"K1 built for {torch.cuda.get_device_name(self.device)}: "
            f"{serve_kernel.owners(self.device)} owner blocks"
        )

    def warmup(self) -> None:
        """Build K1 and launch it once at every batch tier with all-zero
        (inactive) rounds, so no request pays for the nvcc build or the
        module load, then once on the synthetic zero-hit request the JAX
        backend warms with (it leaves the same already-expired row, so the
        two packages' tables stay equal slot for slot); run the
        broadcast-receive upsert once on an empty batch.  Nothing is
        compiled per shape: these launches only load the kernel and size
        its scratch.  Then the state plane's ops run once each with no
        active lane (probe, row gather, upsert, census), so a Store seed,
        a write-through capture or the first census loads no module inside
        a request.  None of this touches persistence or the keymap."""
        now = self.clock.millisecond_now()
        packed = pack_requests(
            [RateLimitReq(name="__warmup__", unique_key="w", hits=0,
                          limit=1, duration=1)],
            self.cfg.batch_size, self.clock,
        )
        with self._lock:
            for t in self._tiers:
                self._launch(np.zeros((1, 12, t), dtype=np.int64),
                             np.full(1, now, dtype=np.int64), 0)
            self._dispatch_rounds_locked(packed.rounds)
            zeros = np.zeros(self.cfg.batch_size, dtype=np.int64)
            self._probe_padded(zeros, now)
            self._gather_rows_finish(
                self._gather_rows_dispatch(zeros, now), len(zeros))
            with self.place.on_stream():
                load_rows(self.table, self._upload_rows(
                    {f: np.zeros(1) for f in BucketRows._fields},
                    slice(None)), now, self.cfg.ways)
        self.table_stats_dispatch(np.zeros((5, 8), dtype=np.int64))()
        self.apply_cached_rows([])
        self.place.synchronize()

    # -- GLOBAL broadcast receive ----------------------------------------
    def apply_cached_rows(self, rows: List[tuple]) -> None:
        """Upsert owner-broadcast statuses: rows of
        (hash_key_str, algorithm, limit, remaining, status, reset_time) —
        the UpdatePeerGlobals receive path (gubernator.go:464-479).  Each
        chunk of `batch_size` rows is one int64[6, B] upload and one
        store-kernel dispatch (its plain version on the CPU)."""
        self._note_keys([c[0] for c in rows])
        B = self.cfg.batch_size
        now = self.clock.millisecond_now()
        with self._lock, self.place.on_stream():
            for lo in range(0, max(len(rows), 1), B):
                chunk = rows[lo:lo + B]
                block = np.zeros((6, len(chunk)), dtype=np.int64)
                if chunk:
                    block[0] = bulk_key_hash64([c[0] for c in chunk])
                    block[1:] = np.array([c[1:6] for c in chunk],
                                         dtype=np.int64).T
                self.table = serve_kernel.store_rows(
                    self.table, self.place.upload(block), now, self.cfg.ways,
                    claim=self.claim,
                    scratch=self.place.scratch_for(1, len(chunk)))

    # -- persistence device hooks (PersistenceHost) ----------------------
    def _chunks(self, n: int):
        B = self.cfg.batch_size
        return [(lo, min(lo + B, n)) for lo in range(0, n, B)]

    def _upload_rows(self, cols: Dict[str, np.ndarray], sel) -> BucketRows:
        """BucketRows of the lanes `sel` of host columns (BucketRows field
        names), uploaded in one pinned copy."""
        return BucketRows(*self.place.upload_cols([
            np.asarray(cols[f], dtype=_ROW_DTYPES[f])[sel]
            for f in BucketRows._fields
        ]))

    def _probe_padded(self, hashes: np.ndarray, now: int) -> np.ndarray:
        """found mask for an int64 hash vector, probed in batch_size chunks
        (caller holds `_lock`); one fetch for all chunks."""
        if not len(hashes):
            return np.zeros(0, dtype=bool)
        with self.place.on_stream():
            h = self.place.upload(np.asarray(hashes, dtype=np.int64))
            found = torch.cat([
                probe_batch(self.table, h[lo:hi], now, self.cfg.ways)[0]
                for lo, hi in self._chunks(len(hashes))
            ])
            return self.place.fetch([found]).wait()[0]

    def _found_mask(self, keys, hashes, now: int) -> np.ndarray:
        return self._probe_padded(_h64s(hashes), now)

    def _bulk_upsert(
        self, rows: List[dict], hashes: List[int], now: int
    ) -> None:
        """load_rows over batch_size chunks (caller holds `_lock`)."""
        if not rows:
            return
        cols = {f: np.array([r[f] for r in rows], dtype=_ROW_DTYPES[f])
                for f in BucketRows._fields if f != "key_hash"}
        cols["key_hash"] = _h64s(hashes)
        with self.place.on_stream():
            for lo, hi in self._chunks(len(rows)):
                load_rows(self.table, self._upload_rows(cols, slice(lo, hi)),
                          now, self.cfg.ways)

    def _gather_rows_dispatch(self, h64: np.ndarray, now: int):
        """Dispatch row gathers for int64 fingerprints (caller holds
        `_lock`) and start their copies to the host.  The gathers are
        fresh tensors and their copies are queued right behind them, so
        the caller may release the lock before `_gather_rows_finish`:
        later launches cannot change what was gathered."""
        parts: List[torch.Tensor] = []
        if len(h64):
            with self.place.on_stream():
                h = self.place.upload(np.asarray(h64, dtype=np.int64))
                for lo, hi in self._chunks(len(h64)):
                    parts.extend(gather_rows(
                        self.table, h[lo:hi], now, self.cfg.ways))
        return self._fetch_later(*parts) if parts else None

    def _gather_rows_finish(self, token, m: int):
        """Wait for a gather token: (int64[10, m] in GATHER_ROW_FIELDS
        order, float64[m] remaining_f)."""
        if token is None:
            return (np.zeros((len(GATHER_ROW_FIELDS), 0), dtype=np.int64),
                    np.zeros(0))
        host = token.wait()
        return (np.concatenate(host[0::2], axis=1)[:, :m],
                np.concatenate(host[1::2])[:m])

    # -- live slot migration (runtime/reshard.py) ------------------------
    def migrate_extract_rows(self, fps: np.ndarray):
        """Atomically gather-and-clear the rows for int64 fingerprints
        `fps`: one ops/state.migrate_extract per batch_size chunk under the
        lock, fetched after it is released.  Returns (int64[10, n] in
        GATHER_ROW_FIELDS order, packed[0] the found mask, float64[n]
        remaining_f)."""
        n = len(fps)
        if not n:
            return np.zeros((10, 0), dtype=np.int64), np.zeros(0)
        now = self.clock.millisecond_now()
        parts: List[torch.Tensor] = []
        with self._lock, self.place.on_stream():
            h = self.place.upload(np.asarray(fps, dtype=np.int64))
            for lo, hi in self._chunks(n):
                self.table, packed, rf = migrate_extract(
                    self.table, h[lo:hi], now, self.cfg.ways)
                parts += [packed, rf]
            pending = self.place.fetch(parts)
        host = pending.wait()
        return (np.concatenate(host[0::2], axis=1),
                np.concatenate(host[1::2]))

    def _inject_chunks(self, cols, chunks, now: int) -> PendingFetch:
        """migrate_inject over the lane index chunks `chunks` (caller
        holds `_lock`); a fetch of the resident-before masks."""
        masks = []
        with self.place.on_stream():
            for sel in chunks:
                self.table, resident = migrate_inject(
                    self.table, self._upload_rows(cols, sel), now,
                    self.cfg.ways)
                masks.append(resident)
            return self.place.fetch(masks)

    @staticmethod
    def _inject_counts(pending: PendingFetch, chunks, cols):
        """(injected, merged) from the resident masks of active lanes."""
        injected = merged = 0
        key = np.asarray(cols["key_hash"], dtype=np.int64)
        for res, sel in zip(pending.wait(), chunks):
            act = key[sel] != 0
            injected += int((act & ~res).sum())
            merged += int((act & res).sum())
        return injected, merged

    def migrate_inject_rows(self, cols: Dict[str, np.ndarray]):
        """Inject-if-absent / merge-if-resident of migrated row columns
        (BucketRows field names): one ops/state.migrate_inject per
        batch_size chunk.  Rows are NOT spread across dispatches, so a
        fourth same-bucket insert in one chunk is dropped, as in the JAX
        backend.  Returns (injected, merged)."""
        n = len(cols["key_hash"])
        if not n:
            return 0, 0
        now = self.clock.millisecond_now()
        chunks = [slice(lo, hi) for lo, hi in self._chunks(n)]
        with self._lock:
            pending = self._inject_chunks(cols, chunks, now)
        return self._inject_counts(pending, chunks, cols)

    # -- the state plane's dispatches (gubstat, the cold tier) -----------
    def table_stats_dispatch(self, shadow_fps: np.ndarray):
        """Dispatch the gubstat census (ops/state.table_stats) under the
        lock and return a zero-arg fetch closure that waits on the
        census's own copy event.  Every leaf of the fetched TableStats
        carries a leading shard axis (length 1 here)."""
        now = self.clock.millisecond_now()
        fps = np.asarray(shadow_fps, dtype=np.int64)
        with self._lock, self.place.on_stream():
            st = table_stats(self.table, self.place.upload(fps), now,
                             self.cfg.ways)
            pending = self.place.fetch(list(st))

        def fetch() -> TableStats:
            return TableStats(*[a[None] for a in pending.wait()])

        return fetch

    def demote_extract_dispatch(self, protect_fps: np.ndarray, batch: int):
        """ONE ops/state.demote_extract under the lock: the `batch` coldest
        unprotected live bucket rows are gathered and their slots cleared
        together.  Returns a zero-arg fetch closure yielding (int64[10,
        batch] in DEMOTE_ROW_FIELDS order, float64[batch] remaining_f)."""
        now = self.clock.millisecond_now()
        fps = np.asarray(protect_fps, dtype=np.int64)
        with self._lock, self.place.on_stream():
            self.table, packed, rf = demote_extract(
                self.table, self.place.upload(fps), now, self.cfg.ways, batch)
            pending = self.place.fetch([packed, rf])

        def fetch():
            packed_h, rf_h = pending.wait()
            return packed_h.reshape(10, batch), rf_h

        return fetch

    def migrate_inject_dispatch(self, cols: Dict[str, np.ndarray]):
        """Dispatch-only inject for the tier's promote path; the returned
        closure resolves (injected, merged).  locate_slots resolves at most
        INSERT_ROUNDS (= 3) same-bucket inserts per call, so same-bucket
        rows are spread over successive dispatches (waves of three) and
        every lane can claim a slot."""
        n = len(cols["key_hash"])
        now = self.clock.millisecond_now()
        nb = self.cfg.num_slots // self.cfg.ways
        fps = np.asarray(cols["key_hash"], dtype=np.int64)
        bucket = fps.view(np.uint64) & np.uint64(nb - 1)
        rank = np.zeros(n, dtype=np.int64)
        seen: Dict[int, int] = {}
        for i in range(n):
            b = int(bucket[i])
            rank[i] = seen.get(b, 0)
            seen[b] = int(rank[i]) + 1
        wave = rank // 3
        B = self.cfg.batch_size
        chunks = []
        for w in range(int(wave.max()) + 1 if n else 0):
            widx = np.flatnonzero(wave == w)
            for lo in range(0, len(widx), B):
                chunks.append(widx[lo:lo + B])
        if not chunks:
            return lambda: (0, 0)
        with self._lock:
            pending = self._inject_chunks(cols, chunks, now)
        return lambda: self._inject_counts(pending, chunks, cols)
