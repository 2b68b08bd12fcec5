"""GLOBAL behavior on the mesh: hot-key replication with collective sync.

Reference semantics (global.go:33-254, gubernator.go:420-479): a GLOBAL key
is served from the local cache on ANY peer — a live owner-broadcast status
answers verbatim; a miss is processed locally "like we own it" — while every
hit is queued, aggregated by key, flushed to the owning peer, applied there,
and the authoritative status broadcast back to all peers.

As in the JAX package, the shards are the peers.  A replicated CACHE table
(every shard holds every broadcast row, so any shard can answer any GLOBAL
key) serves reads; the authoritative state lives in the owner's shard of the
AUTH table (the mesh backend's table).  One sync step replaces the
reference's two RPC loops (sendHits + broadcastPeers):

    psum / all_to_all   hit deltas -> owner      (sendHits, global.go:124-164)
    apply               merged hits -> auth shard
    hits=0 read         broadcast rows           (global.go:214-217)
    all_gather          rows -> every cache shard (UpdatePeerGlobals)

Each shard keeps its replica of the cache, and its auth shard, on its own
device (parallel/sharded.py), so the collectives are copies between the
shards plus int64 adds, each ordered by its streams' events
(runtime/place.carry; on one card the shards' streams wait on each other
and nothing is copied):

    psum        owner d receives row d of every source's delta grid and
                sums over the sources (merge_psum on its [n_src, 1, D]
                slice)
    all_to_all  the same per-(source, owner) copies, then the sort and
                segment sum (merge_a2a on the slice)
    all_gather  every shard receives every owner's broadcast rows, in
                owner order

The owner's apply and its hits=0 re-read are ONE two-round K1 dispatch per
owner shard, on its device and stream (round 0 the merged hits, round 1 the
same lanes with hits = 0), and the broadcast rows come from round 1's
responses.  Each replica upserts the gathered rows with ONE store-kernel
dispatch (ops/kernels/serve_kernel.store_rows: K1's bin, probe and claim
rounds on the replica's claim words, then a row write), on its card's
stream: nothing in the broadcast waits on the host, so the four replicas'
upserts queue back to back and run at once on their cards.

The default collective is psum: the host pending dict already merged
duplicate keys and `_build_chunks` gives each key ONE (owner, lane) slot, so
a key occupies one source's grid and the sum IS the merge.  "a2a" keeps the
all_to_all + sort/segment-sum form; the JAX package pins the two
bit-identical.

One deliberate deviation from the reference, kept from the JAX package: the
owner shard also serves GLOBAL reads from its replicated cache rather than
answering authoritatively (gubernator.go:272-283), so hot keys are not
re-concentrated on their owner.

While a torch.profiler records, the engine logs its stages
(runtime/tracing.py `stage_begin` / `stage_end`): `global.serve` (the ingest
and the queue, with its lanes shipped and active), `global.fetch` (the
responses' wait and unpack), and for a sync `global.build` (with its keys
and chunks), `global.stage`, then a chunk's `global.collect`,
`global.apply` and `global.broadcast` (with the rows offered to the
replicas and the store dispatches).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from gubernator_tpu_torch.core.hashing import key_hash64
from gubernator_tpu_torch.core.types import (
    Algorithm,
    Behavior,
    CacheItem,
    RateLimitReq,
    RateLimitResp,
    Status,
    has_behavior,
)
from gubernator_tpu_torch.ops.batch import pack_requests_grid
from gubernator_tpu_torch.ops.kernels import serve_kernel
from gubernator_tpu_torch.ops.state import KIND_CACHED_RESP, SlotTable
from gubernator_tpu_torch.parallel.mesh import ShardedTensor, shard_of_hash
from gubernator_tpu_torch.parallel.sharded import (
    MeshBackend,
    host_table,
    packed_grid_rounds_to_host,
)
from gubernator_tpu_torch.runtime.backend import (
    probe_bucket,
    rounds_to_qs,
    unmarshal_responses,
)
from gubernator_tpu_torch.runtime.place import carry
from gubernator_tpu_torch.runtime.tracing import stage_begin, stage_end


class DeltaGrid(NamedTuple):
    """Per-(source, owner) aggregated hit deltas: arrays [n_src, n_dst, D]
    (numpy on the host, torch tensors once staged on the device).

    The device form of globalManager's `hits map[string]*RateLimitReq`
    (global.go:87-95), already partitioned by owning shard."""

    key_hash: np.ndarray   # int64
    hits: np.ndarray       # int64 (summed per key)
    limit: np.ndarray      # int64
    duration: np.ndarray   # int64
    algo: np.ndarray       # int32
    burst: np.ndarray      # int64
    is_greg: np.ndarray    # bool
    greg_expire: np.ndarray   # int64
    greg_duration: np.ndarray  # int64


def zero_delta_grid(n: int, D: int) -> DeltaGrid:
    """All-zero [n, n, D] delta grid (key_hash=0 rows are inactive)."""
    z64 = lambda: np.zeros((n, n, D), dtype=np.int64)  # noqa: E731
    return DeltaGrid(
        key_hash=z64(), hits=z64(), limit=z64(), duration=z64(),
        algo=np.zeros((n, n, D), dtype=np.int32), burst=z64(),
        is_greg=np.zeros((n, n, D), dtype=bool),
        greg_expire=z64(), greg_duration=z64(),
    )


_ALGO = DeltaGrid._fields.index("algo")
_ARRIVAL_SHIFT = 44  # disjoint from owner-routing bits (32..) and bucket bits


def arrival_dev(h64, n: int):
    """Serving shard for a GLOBAL key (a Python int, or an array read as
    unsigned 64-bit): a deterministic hash spread on bits disjoint from the
    owner shard and the bucket index.  Stateless — a key's serving shard
    never changes, and every broadcast row exists on every shard, so any
    assignment is correct."""
    if np.isscalar(h64):
        return int((np.uint64(h64) >> np.uint64(_ARRIVAL_SHIFT))
                   % np.uint64(n))
    u = np.asarray(h64).astype(np.uint64)
    return ((u >> np.uint64(_ARRIVAL_SHIFT)) % np.uint64(n)).astype(np.int64)


def _owner_block(key, hits, limit, duration, algo, burst, is_greg, ge, gd):
    """int64[12, ...] request rows in ring-slot order (DeviceBatch field
    order) for merged delta lanes; a lane is active where its key is
    nonzero."""
    z = torch.zeros_like(key)
    return torch.stack([
        key, hits, limit, duration, algo.to(torch.int64), burst, z,
        (is_greg != 0).to(torch.int64), ge, gd,
        (key != 0).to(torch.int64), z,
    ])


def merge_psum(delta: DeltaGrid) -> torch.Tensor:
    """sendHits as ONE psum: the per-source grids are disjoint by host
    construction, so the sum over the source axis IS the merge.  Bools
    ride as int32; int64 lanes add with two's-complement wrap (the JAX
    form sums in uint64, bit-identical), so a violated invariant makes a
    bogus key rather than an overflow.  Returns the owner blocks
    int64[12, n_dst, D]: owner s takes column s (`axis_index`)."""
    return _owner_block(*[
        (a.to(torch.int32) if a.dtype == torch.bool else a).sum(
            dim=0, dtype=a.dtype if a.dtype == torch.int64 else torch.int32)
        for a in delta
    ])


def merge_a2a(delta: DeltaGrid) -> torch.Tensor:
    """sendHits as an all_to_all: owner s receives delta[:, s, :] (the
    transpose), then duplicates across sources merge by a stable sort of
    the keys and a segment sum of the hits into each key's first lane.
    Returns the owner blocks int64[12, n_dst, n_src*D] in sorted order."""
    n = delta.key_hash.shape[1]

    def recv(a):
        return a.transpose(0, 1).reshape(n, -1)  # [n_dst, n_src*D]

    key = recv(delta.key_hash)
    order = torch.argsort(key, dim=1, stable=True)
    ks = torch.gather(key, 1, order)
    first = torch.ones_like(ks, dtype=torch.bool)
    first[:, 1:] = ks[:, 1:] != ks[:, :-1]
    seg = torch.cumsum(first.to(torch.int64), dim=1) - 1
    hsum = torch.zeros_like(ks).scatter_add_(
        1, seg, torch.gather(recv(delta.hits), 1, order))
    act = first & (ks != 0)

    def pick(a):
        return torch.gather(recv(a), 1, order)

    return _owner_block(
        torch.where(act, ks, 0), torch.gather(hsum, 1, seg),
        pick(delta.limit), pick(delta.duration), pick(delta.algo),
        pick(delta.burst), pick(delta.is_greg), pick(delta.greg_expire),
        pick(delta.greg_duration),
    )


@dataclass
class _Pending:
    """One key's queued hits since the last sync (global.go:87-95)."""

    req: RateLimitReq
    hits: int
    src_dev: int


class GlobalEngine:
    """Host-side globalManager: replicated serving + periodic collective
    sync.  Owns the replicated cache (one replica a shard, on the shard's
    device, with its own claim words) and the pending hit aggregation;
    applies authoritative updates to the MeshBackend's auth shards in the
    sync."""

    def __init__(
        self,
        backend: MeshBackend,
        delta_slots: int = 256,
        batch_limit: int = 1000,
        collective: str = "psum",
    ) -> None:
        if collective not in ("psum", "a2a"):
            raise ValueError(
                f"unknown sync collective {collective!r}; expected "
                "'psum' or 'a2a'"
            )
        self.b = backend
        self.n = backend.cfg.num_shards
        self.delta_slots = delta_slots
        self.batch_limit = batch_limit
        self.collective = collective
        self.clock = backend.clock
        # The replicated table's OWN slot budget
        # (DeviceConfig.global_cache_slots; default num_slots, which
        # doubles the table's device memory).
        self.cache_slots = (
            backend.cfg.global_cache_slots
            if backend.cfg.global_cache_slots is not None
            else backend.cfg.num_slots
        )
        self.cache_local = self.cache_slots // self.n
        nb_local = self.cache_local // backend.cfg.ways
        if nb_local & (nb_local - 1):
            raise ValueError(
                f"global cache buckets per shard ({nb_local}) must be a "
                "power of two"
            )
        self.cache_tables, self.cache_claims = backend.new_table(
            self.cache_slots)
        self._merge = merge_psum if collective == "psum" else merge_a2a
        self._lock = threading.Lock()  # cache_tables + pending + metrics
        self.pending: Dict[str, _Pending] = {}
        # Metrics (global.go:48-57 async/broadcast durations + counts).
        self.syncs = 0
        self.sync_keys = 0
        self.dropped = 0
        # Serving calls so far (check and serve_packed): the call number
        # of the stage log (runtime/tracing.py); a sync takes the number
        # of the call it precedes.
        self.calls = 0
        # Post-sync hook, called with the synced pending dict (possibly on
        # a device-executor thread).  The service bridges collective syncs
        # to the RPC tier with it (cross-NODE broadcasts).
        self.on_synced = None

    def _arrival(self, h64):
        return arrival_dev(h64, self.n)

    @property
    def cache_table(self) -> SlotTable:
        """The whole replicated cache on the host, in shard order (a copy:
        the JAX engine's `cache_table` read back)."""
        return host_table(self.b._columns_fetch(
            SlotTable._fields, tables=self.cache_tables,
            lock=self._lock).wait())

    def _ingest(self, rounds, now: int):
        """Serve use_cached grid rounds from the cache replicas (one K1
        launch a shard); caller holds `_lock`.  Returns the responses and
        the lanes shipped (rounds x shards x the block's tier)."""
        qs = rounds_to_qs(rounds, self.b._tiers)
        resps, _ = self.b._launch(
            qs, np.full(len(rounds), now, dtype=np.int64), 0,
            tables=self.cache_tables, claims=self.cache_claims)
        return resps, qs.size // qs.shape[1]

    def _queue(self, req: RateLimitReq, hits: int, src_dev: int) -> None:
        """Queue one key's hits (caller holds `_lock`)."""
        key = req.hash_key()
        p = self.pending.get(key)
        if p is None:
            self.pending[key] = _Pending(req=req, hits=hits, src_dev=src_dev)
        else:
            p.hits += hits
            p.req = req

    # -- serving path ----------------------------------------------------
    def check(self, reqs: Sequence[RateLimitReq]) -> List[RateLimitResp]:
        """Serve GLOBAL checks from the replicated cache
        (getGlobalRateLimit, gubernator.go:420-460) and queue the hits.

        Duplicate keys within one call are pre-aggregated (hits summed,
        global.go:87-95 applied at ingest), so a hot key costs one lane per
        batch and the duplicates share one response."""
        agg_idx: Dict[str, int] = {}
        agg_reqs: List[RateLimitReq] = []
        idx_map: List[int] = []
        for r in reqs:
            if r.name and r.unique_key:
                key = r.hash_key()
                j = agg_idx.get(key)
                if j is not None:
                    a = agg_reqs[j]
                    agg_reqs[j] = RateLimitReq(
                        **{**a.__dict__, "hits": a.hits + r.hits})
                    idx_map.append(j)
                    continue
                agg_idx[key] = len(agg_reqs)
            idx_map.append(len(agg_reqs))
            agg_reqs.append(r)

        packed = pack_requests_grid(
            agg_reqs, self.b.cfg.batch_size, self.n,
            lambda key: self._arrival(key_hash64(key)), self.clock,
        )
        for db in packed.rounds:
            np.copyto(db.use_cached, db.active)
        now = self.clock.millisecond_now()
        ok = [r for j, r in enumerate(agg_reqs) if j not in packed.errors]
        # Persistence hooks, the backend hot path's contract: key strings
        # for the Loader save, and Store seeding of never-seen keys.
        if self.b._keymap is not None:
            self.b._note_keys([r.hash_key() for r in ok])
            self.b._maybe_prune_keymap()
        if self.b.store is not None and ok:
            uniq: Dict[str, RateLimitReq] = {}
            for r in ok:
                uniq.setdefault(r.hash_key(), r)
            # Lock order everywhere: auth (backend) before cache (self).
            with self.b._lock, self._lock:
                self._seed_uniq_from_store(uniq, now)

        with self._lock:
            pending, want_sync = self._serve_locked(packed.rounds, [
                (r, r.hits, self._arrival(key_hash64(r.hash_key())))
                for r in ok], now)

        agg_out, tally = unmarshal_responses(
            len(agg_reqs), packed.errors, packed.positions,
            self.fetch_packed(pending))
        self.b._add_tally(tally)
        if want_sync:
            self.sync()
        return [agg_out[j] for j in idx_map]

    def serve_packed(self, rounds, pend_items):
        """The compiled fast lane's entry: ingest pre-packed use_cached grid
        rounds into the cache table and queue pending hits, under ONE lock
        hold with check()'s ordering (serve, then queue).  `pend_items` is
        [(req, summed_hits, src_dev)], one per unique key.  Returns (a
        PendingFetch of the int64[k, n, 9, B] responses, want_sync); the
        caller fetches outside the lock (`fetch_packed`) and calls sync()
        when want_sync.  Stage `global.serve` (the ingest and the queue)
        counts the lanes shipped and those that carry a request."""
        now = self.clock.millisecond_now()
        if self.b._keymap is not None:
            self.b._note_keys([req.hash_key() for req, _h, _s in pend_items])
            self.b._maybe_prune_keymap()
        if self.b.store is not None and pend_items:
            uniq: Dict[str, RateLimitReq] = {}
            for req, _h, _s in pend_items:
                uniq.setdefault(req.hash_key(), req)
            with self.b._lock, self._lock:
                self._seed_uniq_from_store(uniq, now)
        with self._lock:
            return self._serve_locked(rounds, pend_items, now)

    def _serve_locked(self, rounds, pend_items, now: int):
        """Serve `rounds` from the replicas at `now` and queue `pend_items`
        [(req, hits, src_dev)] after it (the deferred QueueHit,
        gubernator.go:429-432), as the next call; caller holds `_lock`.
        Returns (a PendingFetch of the responses or None, want_sync)."""
        self.calls += 1
        t = stage_begin()
        resps, lanes = None, 0
        if rounds:
            resps, lanes = self._ingest(rounds, now)
            resps = self.b._fetch_later(resps)
        for req, hits, src_dev in pend_items:
            self._queue(req, hits, src_dev)
        if t:
            stage_end("global.serve", self.calls, t, {
                "lanes": lanes,
                "active": sum(int(np.count_nonzero(db.active))
                              for db in rounds)})
        return resps, len(self.pending) >= self.batch_limit

    def fetch_packed(self, resps, call=None):
        """serve_packed's responses on the host, one dict of [n, B]
        columns a round (`[]` for None): the wait on the shards' own
        events and the unpack, as stage `global.fetch` of `call` (the
        latest serving call by default)."""
        t = stage_begin()
        host = (packed_grid_rounds_to_host(resps) if resps is not None
                else [])
        stage_end("global.fetch", self.calls if call is None else call, t)
        return host

    # -- sync path -------------------------------------------------------
    def _seed_uniq_from_store(self, uniq: Dict[str, RateLimitReq],
                              now: int) -> None:
        """Store.get for keys with no live row in the cache table; hits
        upsert into BOTH tables — the auth table (owner-routed, where sync
        applies hits, the s.Get of algorithms.go:45-51) and the cache
        (arrival-routed, so pre-sync serving reflects persisted state).
        Caller holds b._lock then self._lock."""
        from gubernator_tpu_torch.runtime.store import item_to_row_fields

        keys = list(uniq)
        hashes = [key_hash64(k) for k in keys]
        found, _ = self.b._probe_grid(
            keys, hashes, now, tables=self.cache_tables,
            route=self._arrival)
        rows: List[dict] = []
        row_hashes: List[int] = []
        for k, h, f in zip(keys, hashes, found):
            if f:
                continue
            item = self.b.store.get(uniq[k])
            if item is None or item.is_expired(now):
                continue
            rows.append(item_to_row_fields(item))
            row_hashes.append(h)
        if rows:
            self.b._bulk_upsert(rows, row_hashes, now)
            self.b._bulk_upsert_into(self.cache_tables, rows, row_hashes,
                                     now, self._arrival)

    def _stage(self, grid: DeltaGrid) -> List[torch.Tensor]:
        """Upload a host delta grid: source s's rows go to its device as
        one int64[9, n_dst, D] copy (DeltaGrid field order; int32 and bool
        widened)."""
        packed = np.stack([np.asarray(a, dtype=np.int64) for a in grid],
                          axis=1)  # [n_src, 9, n_dst, D]
        return self.b._parts(packed, 0)

    def _receive(self, staged: List[torch.Tensor]) -> List[torch.Tensor]:
        """sendHits: owner d receives column d of every source's grid (the
        psum's or all_to_all's copies) and merges it on its device.
        Returns owner d's int64[2, 12, L] block on its device: the merged
        lanes, then the same lanes with hits = 0."""
        shards = self.b.shards
        out = []
        for d, owner in enumerate(shards):
            recv = [carry(staged[s][:, d], shards[s], owner)
                    for s in range(self.n)]
            with owner.on_stream():
                g = torch.stack(recv)  # [n_src, 9, D]
                q = self._merge(DeltaGrid(*[
                    (g[:, i].to(torch.int32) if i == _ALGO else g[:, i])
                    .unsqueeze(1) for i in range(len(DeltaGrid._fields))
                ]))[:, 0]  # [12, L]
                q0 = q.clone()
                q0[1] = 0
                out.append(torch.stack([q, q0]))
        return out

    def _all_gather(self, rows: List[torch.Tensor]) -> List[torch.Tensor]:
        """UpdatePeerGlobals: every replica receives every owner's
        int64[6, L] broadcast rows, concatenated in owner order into
        int64[6, n*L] on its device."""
        shards = self.b.shards
        out = []
        for c, place in enumerate(shards):
            got = [carry(rows[d], shards[d], place) for d in range(self.n)]
            with place.on_stream():
                out.append(torch.cat(got, dim=1))
        return out

    def _sync_step(self, staged: List[torch.Tensor], now: int,
                   call: int = 0, keys: int = 0) -> None:
        """One collective sync of a staged chunk of `keys` keys; caller
        holds b._lock then self._lock.  The owners receive and merge
        (`_receive`, stage `global.collect`); each runs its merged lanes as
        one two-round K1 dispatch on its auth shard (hits, then hits = 0)
        and takes its broadcast rows from round 1 (`global.apply`); every
        replica receives the owners' rows (`_all_gather`) and upserts them
        with one store-kernel dispatch on its stream, with no host wait
        (`global.broadcast`, counting the rows offered to the replicas,
        keys x replicas, and the store dispatches)."""
        shards = self.b.shards
        t = stage_begin()
        qs = self._receive(staged)
        stage_end("global.collect", call, t)
        t = stage_begin()
        resps, _ = self.b._launch(
            ShardedTensor(qs, [p.stream for p in shards], 2),
            np.full(2, now, dtype=np.int64), 0)
        rows = []
        for d, owner in enumerate(shards):
            with owner.on_stream():
                q, r1 = qs[d][0], resps.parts[d][1]  # [12, L], [9, L]
                rows.append(torch.stack([
                    torch.where(q[10] != 0, q[0], 0), q[4], r1[1], r1[2],
                    r1[0], r1[3]]))  # CachedRows order
        stage_end("global.apply", call, t)
        t = stage_begin()
        before = serve_kernel.store_launches
        for c, r in enumerate(self._all_gather(rows)):
            place = shards[c]
            with place.on_stream():
                serve_kernel.store_rows(
                    self.cache_tables[c], r, now, self.b.cfg.ways,
                    claim=self.cache_claims[c],
                    scratch=place.scratch_for(1, r.shape[1]))
        if t:
            stage_end("global.broadcast", call, t, {
                "rows": keys * self.n,
                "launches": serve_kernel.store_launches - before})

    def sync(self) -> int:
        """Run the collective hits->owner->broadcast step; returns #keys.
        Its stages carry the number of the serve_packed call it precedes;
        `global.build` counts the keys packed and their chunks."""
        with self._lock:
            pending, self.pending = self.pending, {}
            call = self.calls + 1
        if not pending:
            return 0
        t = stage_begin()
        chunks = self._build_chunks(pending, self.clock.now())
        chunk_keys = [int(np.count_nonzero(g.key_hash)) for g in chunks]
        if t:
            stage_end("global.build", call, t, {"keys": len(pending),
                                                "chunks": len(chunks)})
        now = self.clock.millisecond_now()
        # Uploads read no table state: stage them BEFORE taking the locks,
        # so concurrent checks block only for the sync steps.
        t = stage_begin()
        staged = [self._stage(grid) for grid in chunks]
        stage_end("global.stage", call, t)
        cap_keys = cap_token = wt_seq = None
        # Lock order: auth (backend) before cache (self).
        with self.b._lock, self._lock:
            for delta, keys in zip(staged, chunk_keys):
                self._sync_step(delta, now, call, keys)
            if self.b.store is not None:
                # Post-sync auth rows -> Store.on_change (the write-through
                # of algorithms.go:154-158, batch-granular at the sync
                # tier): gathers queued in the lock, fetched outside it.
                cap_keys = list(pending.keys())
                h64 = np.array([key_hash64(k) for k in cap_keys],
                               dtype=np.uint64).view(np.int64)
                cap_token = self.b._gather_rows_dispatch(h64, now)
                wt_seq = self.b._wt_ticket()
            self.syncs += 1
            self.sync_keys += len(pending)
        if cap_keys is not None:
            captured: list = []
            try:
                a, rf = self.b._gather_rows_finish(cap_token, len(cap_keys))
                captured = self._captured_items(cap_keys, pending, a, rf)
            finally:
                # Redeem the ticket even if a fetch fails: an unredeemed
                # ticket wedges every later delivery.
                self.b._deliver_write_through(captured, wt_seq)
        if self.on_synced is not None:
            self.on_synced(pending)
        return len(pending)

    def _captured_items(self, keys, pending, a, rf) -> list:
        """(req, CacheItem) pairs from packed GATHER_ROW_FIELDS columns;
        misses and KIND_CACHED_RESP rows are skipped, as
        _read_items_locked skips them."""
        out: list = []
        for j, key in enumerate(keys):
            if not a[0, j] or a[1, j] == KIND_CACHED_RESP:
                continue
            algo = Algorithm(int(a[2, j]))
            remaining = (
                float(rf[j]) if algo == Algorithm.LEAKY_BUCKET
                else int(a[5, j])
            )
            out.append((pending[key].req, CacheItem(
                key=key,
                algorithm=algo,
                expire_at=int(a[9, j]),
                limit=int(a[3, j]),
                duration=int(a[4, j]),
                remaining=remaining,
                created_at=int(a[6, j]),
                status=Status(int(a[7, j])),
                burst=int(a[8, j]),
            )))
        return out

    def _build_chunks(self, pending: Dict[str, _Pending],
                      now_dt) -> List[DeltaGrid]:
        """Pack pending deltas into [n, n, D] grids (chunked on overflow).
        Lane counters are per (chunk, OWNER), shared across sources, so
        every key gets a globally unique (owner, lane) slot within a chunk:
        the psum step's premise, and a plain permutation for a2a."""
        from gubernator_tpu_torch.core.interval import (
            GregorianError,
            gregorian_duration,
            gregorian_expiration,
        )

        n, D = self.n, self.delta_slots
        chunks: List[DeltaGrid] = []
        fill: List[np.ndarray] = []  # [n_dst] lane counters per chunk
        for key, p in pending.items():
            r = p.req
            h64 = key_hash64(key)
            dst = int(shard_of_hash(h64, n))
            is_greg = has_behavior(r.behavior, Behavior.DURATION_IS_GREGORIAN)
            ge = gd = 0
            if is_greg:
                try:
                    ge = gregorian_expiration(now_dt, r.duration)
                    gd = gregorian_duration(now_dt, r.duration)
                except GregorianError:
                    with self._lock:
                        self.dropped += 1
                    continue
            ci = next((c for c in range(len(chunks)) if fill[c][dst] < D),
                      None)
            if ci is None:
                chunks.append(zero_delta_grid(n, D))
                fill.append(np.zeros(n, dtype=np.int64))
                ci = len(chunks) - 1
            g, lane, src = chunks[ci], int(fill[ci][dst]), p.src_dev
            at = (src, dst, lane)
            g.key_hash[at] = np.uint64(h64).view(np.int64)
            g.hits[at] = p.hits
            g.limit[at] = r.limit
            g.duration[at] = r.duration
            g.algo[at] = int(r.algorithm)
            g.burst[at] = r.burst if r.burst != 0 else r.limit
            g.is_greg[at] = is_greg
            g.greg_expire[at] = ge
            g.greg_duration[at] = gd
            fill[ci][dst] = lane + 1
        if not chunks:
            chunks.append(zero_delta_grid(n, D))
        return chunks

    def warmup(self) -> None:
        """Run the sync step once on an all-zero delta grid (key_hash=0
        lanes are inactive: the tables are unchanged) and the cache ingest
        at every batch tier, so nothing loads inside the serving cadence."""
        staged = self._stage(zero_delta_grid(self.n, self.delta_slots))
        now = self.clock.millisecond_now()
        with self.b._lock, self._lock:
            self._sync_step(staged, now)
            for t in self.b._tiers:
                self.b._launch(
                    np.zeros((1, 12, self.n, t), dtype=np.int64),
                    np.full(1, now, dtype=np.int64), 0,
                    tables=self.cache_tables, claims=self.cache_claims)

    # -- point reads (tests / HealthCheck) -------------------------------
    def _cache_bucket_offset(self, key: str, shard: int) -> int:
        """Row index of `key`'s bucket in the whole cache (shard-major; its
        geometry may differ from the auth table's via
        global_cache_slots)."""
        nb_local = self.cache_local // self.b.cfg.ways
        bucket = key_hash64(key) & (nb_local - 1)
        return shard * self.cache_local + bucket * self.b.cfg.ways

    def get_cached(self, key: str):
        """Read this key's row from its serving shard's replica."""
        ways = self.b.cfg.ways
        lo = self._cache_bucket_offset(key, self._arrival(key_hash64(key)))
        now = self.clock.millisecond_now()
        rows = self.b._columns_fetch(SlotTable._fields, lo, ways,
                                     tables=self.cache_tables,
                                     lock=self._lock).wait()
        return probe_bucket(
            dict(zip(SlotTable._fields, rows)), ways, key, now)

    def cache_occupancy(self) -> int:
        """Live rows in the replicated serving tables (exported as
        gubernator_global_cache_size)."""
        with self._lock:
            pending = self.b._occupancy_dispatch(self.cache_tables)
        return int(pending.wait()[0].sum())
