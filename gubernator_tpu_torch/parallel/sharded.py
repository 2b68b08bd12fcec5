"""The sharded slot table over one card or more: the mesh engine.

The JAX package shards the slot table's slot axis over a device mesh; each
device owns `num_slots / n` slots and is the single writer for the keys that
hash to it — the single-writer-by-placement discipline of the reference
worker pool (workers.go:19-37) and peer ring (architecture.md:13-17).  Here
shard s keeps its own table, claim-word buffer, stream and K1 scratch on its
device (parallel/mesh.make_mesh: `devices[s % len(devices)]`, by default
every visible card), so four shards take four cards, or four streams of
one.  A snapshot concatenates the shards in shard order, so it equals the
JAX `table_to_host` word for word.

The JAX lifts (`shard_map` of one single-table body) become plain functions
that loop over the shards and call the port's single-table function on that
shard's table, on its stream:

    JAX lift                          here                  on the card
    make_sharded_step_packed,
    make_mesh_ring_step,
    make_mesh_mega_ring_step          mesh_ring_step        K1 once a shard
    make_sharded_row_op               sharded_row_op        load_rows
    UpdatePeerGlobals' upsert         apply_cached_rows     the store kernel
    make_sharded_probe                sharded_probe         probe_batch
    make_sharded_gather               sharded_gather        gather_rows
    make_sharded_demote_extract       sharded_demote_extract demote_extract
    make_sharded_table_stats          sharded_table_stats   table_stats

(megaround's r x s rounds go out as one mesh_ring_step of r*s rounds, as
the single-table backend's do).  Every single-table op updates its table in
place.  The hot path needs no collective: routing already placed every
request on its owner shard.  A dispatch of `n` shards is one host-side
split of the request block, then for each shard an upload of its part, a
K1 launch and (for the caller) a fetch, all on that shard's stream: the
cards, or the streams of one card, run them concurrently.  Results stay
where they were made (`ShardedTensor`) and travel to the host behind each
stream's own event (runtime/place.py: each shard is a `DevicePlace`, and
every crossing goes through its members).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.core.hashing import key_hash64
from gubernator_tpu_torch.core.types import RateLimitReq
from gubernator_tpu_torch.ops.batch import (
    PackedGrid,
    pack_batch_q,
    pack_requests_grid,
)
from gubernator_tpu_torch.ops.kernels import serve_kernel
from gubernator_tpu_torch.ops.state import (
    COLUMN_DTYPES,
    SlotTable,
    TableStats,
    demote_extract,
    init_table,
    table_from_host,
    table_stats,
)
from gubernator_tpu_torch.ops.step import (
    GATHER_ROW_FIELDS,
    BucketRows,
    gather_rows,
    load_rows,
    probe_batch,
)
from gubernator_tpu_torch.parallel.mesh import (
    ShardedTensor,
    make_mesh,
    shard_of_hash,
)
from gubernator_tpu_torch.runtime.backend import (
    _ROW_DTYPES,
    TorchDeviceHost,
    _h64s,
    packed_rounds_to_host,
)
from gubernator_tpu_torch.runtime.place import DevicePlace, PendingFetch, carry


def pack_requests_sharded(
    reqs: Sequence[RateLimitReq],
    batch_size: int,
    n_shards: int,
    clock=None,
    use_cached: Optional[Sequence[bool]] = None,
) -> PackedGrid:
    """Route each request to its owning shard and pack per-shard lanes:
    ops.batch.pack_requests' contract (validation, duplicate-key rounds)
    with one more coordinate, the shard; capacity is batch_size lanes per
    (round, shard)."""
    return pack_requests_grid(
        reqs, batch_size, n_shards,
        lambda key: int(shard_of_hash(key_hash64(key), n_shards)),
        clock, use_cached,
    )


# An [n, B] grid round packs into one int64[12, n, B] host array.
pack_grid_batch = pack_batch_q

# int64[k, n, 9, B] responses -> per-round dicts of [n, B] columns, so
# (shard, lane) positions index them directly.
packed_grid_rounds_to_host = packed_rounds_to_host


def drain_to_grids(
    shards: np.ndarray, n: int, B: int
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Place items, in order, into consecutive [n, B] grids: item j goes to
    shard `shards[j]`, on the next free lane of that shard, and a shard's
    overflow spills into the next grid.  Yields (sel, shard, lane) per grid:
    the indices of the items it holds and their coordinates."""
    sh = np.asarray(shards, dtype=np.int64)
    m = len(sh)
    if not m:
        return
    order = np.argsort(sh, kind="stable")
    starts = np.concatenate(([0], np.cumsum(np.bincount(sh, minlength=n))))
    rank = np.empty(m, dtype=np.int64)
    rank[order] = np.arange(m) - starts[sh[order]]
    grid = rank // B
    for g in range(int(grid.max()) + 1):
        sel = np.flatnonzero(grid == g)
        yield sel, sh[sel], rank[sel] % B


def _hash_grid(h64: np.ndarray, shards: np.ndarray, n: int, B: int):
    """(int64[n, B] fingerprint grid, int64[n, B] item index grid, -1 on
    empty lanes) per drained grid of `h64` routed by `shards`."""
    for sel, s, lane in drain_to_grids(shards, n, B):
        hv = np.zeros((n, B), dtype=np.int64)
        jv = np.full((n, B), -1, dtype=np.int64)
        hv[s, lane] = h64[sel]
        jv[s, lane] = sel
        yield hv, jv


# -- moving data between shards -------------------------------------------
def fetch_sharded(items: Sequence[ShardedTensor]) -> PendingFetch:
    """Start copying shard results (ShardedTensors split over the same
    shards) to the host, each part on its stream (`fetch_parts`)."""
    return fetch_parts([DevicePlace(p.device, st) for it in items[:1]
                        for p, st in zip(it.parts, it.streams)], items)


def fetch_parts(places: Sequence[DevicePlace],
                items: Sequence[ShardedTensor]) -> PendingFetch:
    """Start copying shard results split over `places` to the host: one
    pinned block an item, and for each shard one `DevicePlace.fetch` of
    its parts into its stretch of the blocks, on its stream, right behind
    the work that made them.  The fetch gives each ShardedTensor whole
    (its parts stacked on its axis)."""
    if not items:
        return PendingFetch([], list)
    blocks = [places[0].host_buffer(
        (len(it.parts),) + tuple(it.parts[0].shape), it.parts[0].dtype)
        for it in items]
    axes = [it.axis for it in items]  # the finish keeps no device tensor
    fetches = []
    for s, place in enumerate(places):
        with place.on_stream():
            fetches.append(place.fetch([it.parts[s] for it in items],
                                       [blk[s] for blk in blocks]))
    return PendingFetch.join(fetches, lambda: [
        np.moveaxis(blk.numpy(), 0, ax) for blk, ax in zip(blocks, axes)])


# -- the lifts ------------------------------------------------------------
def mesh_ring_step(
    shards: Sequence[DevicePlace],
    tables: Sequence[SlotTable],
    qs: Sequence[torch.Tensor],    # shard s: int64[k, 12, B] on its device
    nows: Sequence[torch.Tensor],  # shard s: int64[k]
    seq: Sequence[torch.Tensor],   # shard s: its int64 sequence word
    ways: int = 8,
    claims: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> Tuple[ShardedTensor, ShardedTensor]:
    """k packed rounds on every shard: (int64[k, n, 9, B], seq + k [n]).

    Shard s runs the serve kernel (ops/kernels/serve_kernel.py; its plain
    `ring_step` on the CPU) on its own table with its own parts, already on
    its device, on its stream, with its claim words and its place's
    scratch: a mesh step is one single-table step per shard by
    construction, and the n launches go out on n streams."""
    resps, seqs = [], []
    for s, place in enumerate(shards):
        with place.on_stream():
            k, _, B = qs[s].shape
            _, r, sq = serve_kernel.persistent_serve_step(
                tables[s], qs[s], nows[s], seq[s], ways,
                claim=claims[s] if claims is not None else None,
                scratch=place.scratch_for(k, B))
        resps.append(r)
        seqs.append(sq)
    streams = [p.stream for p in shards]
    return ShardedTensor(resps, streams, 1), ShardedTensor(seqs, streams, 0)


def sharded_row_op(op: Callable, shards: Sequence[DevicePlace],
                   tables: Sequence[SlotTable], rows: Sequence, now,
                   ways: int = 8) -> None:
    """Row upserts on every shard: `op` (ops/step.load_rows — Loader
    restore, Store seeding) on shard s's table, on its stream, with its
    rows `rows[s]` (a row tuple of [B] tensors on its device)."""
    for s, place in enumerate(shards):
        with place.on_stream():
            op(tables[s], rows[s], now, ways)


def _each(shards, fn) -> list:
    """fn(s) for every shard, on its stream."""
    out = []
    for s, place in enumerate(shards):
        with place.on_stream():
            out.append(fn(s))
    return out


def _sharded(parts: list, shards, axis: int = 0) -> ShardedTensor:
    return ShardedTensor(parts, [p.stream for p in shards], axis)


def sharded_probe(shards, tables, h: Sequence[torch.Tensor], now,
                  ways: int = 8) -> Tuple[ShardedTensor, ShardedTensor]:
    """Read-only lookup of an [n, B] fingerprint grid (`h[s]` on shard s):
    (found bool[n, B], shard-local slot int64[n, B])."""
    out = _each(shards, lambda s: probe_batch(tables[s], h[s], now, ways))
    return (_sharded([f for f, _ in out], shards),
            _sharded([sl for _, sl in out], shards))


def sharded_gather(shards, tables, h: Sequence[torch.Tensor], now,
                   ways: int = 8) -> Tuple[ShardedTensor, ShardedTensor]:
    """Row read-back of an [n, B] fingerprint grid: (int64[n, 10, B] in
    GATHER_ROW_FIELDS order, float64[n, B] remaining_f)."""
    out = _each(shards, lambda s: gather_rows(tables[s], h[s], now, ways))
    return (_sharded([p for p, _ in out], shards),
            _sharded([rf for _, rf in out], shards))


def sharded_demote_extract(shards, tables, protect: Sequence[torch.Tensor],
                           now, ways: int = 8, batch: int = 64):
    """Tier demotion on every shard: each picks its own `batch` coldest
    unprotected rows on its table (victim choice is shard-local, as the
    bucket-local pseudo-LRU is bucket-local) and clears them.  The protect
    list is shared (`protect[s]`, a copy on each device): a shadow key only
    matches on its home shard.  Returns (int64[n, 10, batch],
    float64[n, batch])."""
    out = _each(shards, lambda s: demote_extract(
        tables[s], protect[s], now, ways, batch)[1:])
    return (_sharded([p for p, _ in out], shards),
            _sharded([rf for _, rf in out], shards))


def sharded_table_stats(shards, tables, shadow_fps: Sequence[torch.Tensor],
                        now, ways: int = 8) -> TableStats:
    """The gubstat census on every shard, each leaf with a leading [n]
    axis: per-shard occupancy for free, sums for totals.  A derived key
    only matches on its home shard, so per-class sums are exact."""
    out = _each(shards, lambda s: table_stats(tables[s], shadow_fps[s], now,
                                              ways))
    return TableStats(*[_sharded(list(leaf), shards) for leaf in zip(*out)])


class MeshBackend(TorchDeviceHost):
    """The JAX package's MeshBackend: the table split into
    `cfg.num_shards` shards, shard s on `devices[s % len(devices)]` (by
    default every visible card; the CPU for DeviceConfig(platform="cpu")),
    each with its own table, claim words, stream and K1 scratch."""

    def __init__(
        self,
        cfg: DeviceConfig,
        clock=None,
        devices=None,
        metrics=None,
        store=None,
        track_keys: bool = False,
    ) -> None:
        if cfg.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        who = type(self).__name__
        self.n = cfg.num_shards
        self.shards = [DevicePlace.fresh(d)
                       for d in make_mesh(self.n, cfg.device, devices, who)]
        self._init_host(cfg, clock, metrics, store, track_keys,
                        DevicePlace.resolve(self.shards[0].device, who))
        self.local_slots = cfg.num_slots // self.n
        nb_local = self.local_slots // cfg.ways
        if nb_local & (nb_local - 1):
            raise ValueError(
                f"buckets per shard ({nb_local}) must be a power of two"
            )
        self.tables, self.claims = self.new_table(cfg.num_slots)

    @property
    def shard_devices(self) -> List[str]:
        """Shard s's device, by shard (/debug/vars `shard_devices`)."""
        return [str(p.device) for p in self.shards]

    def new_table(self, num_slots: int):
        """(one empty table of num_slots / n slots a shard, on its device;
        each shard's claim-word buffer — None on the CPU).  The
        GlobalEngine's cache replicas are made here too."""
        L = num_slots // self.n
        tables = _each(self.shards, lambda s: init_table(
            L, self.shards[s].device))
        claims = [place.claim_words(L) for place in self.shards]
        return tables, claims

    @property
    def table(self) -> SlotTable:
        """The whole auth table on the host, in shard order (a copy, as
        `np.asarray` of the JAX mesh's sharded table is)."""
        return host_table(self._columns_fetch(SlotTable._fields).wait())

    def _pack(self, reqs, use_cached=None):
        return pack_requests_sharded(
            reqs, self.cfg.batch_size, self.n, self.clock, use_cached)

    # -- moving requests to the shards -----------------------------------
    def _parts(self, a, axis: Optional[int]) -> List[torch.Tensor]:
        """Shard s's part of `a` on its device, queued on its stream:
        `a` taken at index s of `axis` (all of it when axis is None).
        `a` is a host array (uploaded pinned, one copy a shard), a
        ShardedTensor (its parts, already in place) or a tensor made on
        its device's current stream."""
        if isinstance(a, ShardedTensor):
            return a.parts
        if not isinstance(a, torch.Tensor) or a.device.type == "cpu":
            a = np.asarray(a)

            def up(s):
                part = a if axis is None else np.moveaxis(a, axis, 0)[s]
                return self.shards[s].upload(part)

            return _each(self.shards, up)
        src = DevicePlace.resolve(a.device, type(self).__name__)
        out = []
        for s, place in enumerate(self.shards):
            part = carry(a if axis is None else a.select(axis, s), src, place)
            with place.on_stream():
                out.append(part.contiguous())
        return out

    def _launch(self, qs, nows, seq, tables=None, claims=None):
        """One mesh dispatch of `qs` int64[k, 12, n, B]: K1 once per shard
        on `tables` (the auth tables by default) and their claim words,
        each shard's [k, 12, B] part uploaded to its device.  Caller holds
        the tables' lock.  Returns the un-synced (int64[k, n, 9, B],
        seq + k per shard), both ShardedTensors."""
        if tables is None:
            tables, claims = self.tables, self.claims
        if not isinstance(seq, (torch.Tensor, ShardedTensor)):
            seq = np.asarray(seq, dtype=np.int64)
            seq = np.broadcast_to(seq, (self.n,) + seq.shape[1:])
        return mesh_ring_step(
            self.shards, tables, self._parts(qs, 2), self._parts(nows, None),
            self._parts(seq, 0), self.cfg.ways, claims)

    def _fetch_later(self, *items: ShardedTensor) -> PendingFetch:
        """Start copying shard results to the host, each part behind its
        own stream's event; caller holds the lock, right after the
        dispatch that made them."""
        return fetch_parts(self.shards, items)

    # -- ring drain discipline (runtime/ring.py) -------------------------
    def ring_q_shape(self, tb: int) -> tuple:
        """Per-round request-slot shape at batch tier `tb`: the grid form
        [12, n_shards, tb]."""
        return (12, self.n, tb)

    def ring_seq_init(self) -> ShardedTensor:
        """Fresh per-shard sequence words ([n], one on each shard)."""
        return _sharded(_each(self.shards, lambda s: torch.zeros(
            (), dtype=torch.int64, device=self.shards[s].device)),
            self.shards)

    def persistent_serve_supported(self):
        """The JAX package's persistent kernel owns ONE table block and
        its mesh has no lift of it: megaround is the mesh's
        dispatch-amortization tier, here as there."""
        return False, (
            "persistent serve kernel is single-table only; mesh "
            "backends serve megaround (the shard_map mega ring step)"
        )

    def warmup(self) -> None:
        """Launch K1 on every shard at every batch tier with inactive
        rounds, then on the synthetic zero-hit requests the JAX mesh warms
        with (they leave the same already-expired rows, so the two
        packages' tables stay equal slot for slot), and run the state
        plane's ops once each on an empty grid.  No persistence hook, no
        keymap, no tally."""
        n, B = self.n, self.cfg.batch_size
        now = self.clock.millisecond_now()
        packed = self._pack([
            RateLimitReq(name="__warmup__", unique_key=f"w{s}", hits=0,
                         limit=1, duration=1)
            for s in range(n)
        ])
        zeros = np.zeros((n, B), dtype=np.int64)
        with self._lock:
            for t in self._tiers:
                self._launch(np.zeros((1, 12, n, t), dtype=np.int64),
                             np.full(1, now, dtype=np.int64), 0)
            self._dispatch_rounds_locked(packed.rounds)
            h = self._parts(zeros, 0)
            sharded_probe(self.shards, self.tables, h, now, self.cfg.ways)
            sharded_gather(self.shards, self.tables, h, now, self.cfg.ways)
            rows = self._upload_grid([
                np.zeros((n, B), dtype=_ROW_DTYPES[f])
                for f in BucketRows._fields], BucketRows)
            sharded_row_op(load_rows, self.shards, self.tables, rows, now,
                           self.cfg.ways)
        self.table_stats_dispatch(np.zeros((5, 8), dtype=np.int64))()
        self.synchronize()

    def synchronize(self) -> None:
        """Wait for every shard's stream."""
        for p in self.shards:
            p.synchronize()

    # -- GLOBAL broadcast receive ----------------------------------------
    def apply_cached_rows(self, rows: Sequence[tuple]) -> None:
        """Upsert owner-broadcast statuses, routed to their shards: rows of
        (hash_key_str, algorithm, limit, remaining, status, reset_time).
        Each [n, B] grid of them is one int64[6, B] block a shard and one
        store-kernel dispatch on its stream, with its claim words."""
        self._note_keys([c[0] for c in rows])
        if not rows:
            return
        h64 = _h64s([key_hash64(c[0]) for c in rows])
        cols = np.array([c[1:6] for c in rows], dtype=np.int64)
        n, B = self.n, self.cfg.batch_size
        now = self.clock.millisecond_now()
        with self._lock:
            for sel, s, lane in drain_to_grids(shard_of_hash(h64, n), n, B):
                grid = np.zeros((n, 6, B), dtype=np.int64)
                grid[s, 0, lane] = h64[sel]
                grid[s, 1:, lane] = cols[sel]
                for d, (place, block) in enumerate(
                        zip(self.shards, self._parts(grid, 0))):
                    with place.on_stream():
                        serve_kernel.store_rows(
                            self.tables[d], block, now, self.cfg.ways,
                            claim=self.claims[d],
                            scratch=place.scratch_for(1, B))

    def _upload_grid(self, grid: Sequence[np.ndarray], row_type) -> list:
        """[n, B] host columns -> shard s's `row_type` of [B] tensors on
        its device, one pinned copy a shard (`DevicePlace.upload_cols`)."""
        return _each(self.shards, lambda s: row_type(
            *self.shards[s].upload_cols(
                [np.ascontiguousarray(g[s]) for g in grid])))

    def _upsert_grid(self, tables, cols, shards, now):
        """load_rows over BucketRows given as host columns, drained into
        [n, B] grids by `shards`; caller holds the tables' lock."""
        n, B = self.n, self.cfg.batch_size
        for sel, s, lane in drain_to_grids(shards, n, B):
            grid = []
            for c in cols:
                g = np.zeros((n, B), dtype=c.dtype)
                g[s, lane] = c[sel]
                grid.append(g)
            sharded_row_op(load_rows, self.shards, tables,
                           self._upload_grid(grid, BucketRows), now,
                           self.cfg.ways)

    # -- point reads / persistence ---------------------------------------
    def bucket_offset(self, key: str) -> int:
        """Row index of `key`'s bucket in the whole table (shard-major)."""
        h = key_hash64(key)
        nb_local = self.local_slots // self.cfg.ways
        shard = int(shard_of_hash(h, self.n))
        return shard * self.local_slots + (h & (nb_local - 1)) * self.cfg.ways

    def _probe_grid(self, keys, hashes, now: int, tables=None, route=None):
        """Shard-routed batched probes: (found, global slot) per key, in
        key order, one fetch for every chunk (lock held).  `tables`/`route`
        default to the auth tables with owner routing; the GlobalEngine
        passes its cache replicas with arrival routing.  Their geometry
        may differ from the auth tables' (global_cache_slots)."""
        if tables is None:
            tables = self.tables
        n = self.n
        local = tables[0].key.shape[0]
        h64 = _h64s(hashes)
        shards = (route or (lambda h: shard_of_hash(h, n)))(h64)
        found = np.zeros(len(keys), dtype=bool)
        gslot = np.zeros(len(keys), dtype=np.int64)
        grids = list(_hash_grid(h64, shards, n, self.cfg.batch_size))
        if not grids:
            return found, gslot
        outs: List[ShardedTensor] = []
        for hv, _ in grids:
            outs.extend(sharded_probe(self.shards, tables,
                                      self._parts(hv, 0), now,
                                      self.cfg.ways))
        host = self._fetch_later(*outs).wait()
        for i, (_, jv) in enumerate(grids):
            f, sl = host[2 * i], host[2 * i + 1]
            at = jv >= 0
            found[jv[at]] = f[at]
            gslot[jv[at]] = (np.arange(n)[:, None] * local + sl)[at]
        return found, gslot

    def _found_mask(self, keys, hashes, now: int) -> np.ndarray:
        return self._probe_grid(keys, hashes, now)[0]

    def _gather_rows_dispatch(self, h64: np.ndarray, now: int):
        """Dispatch shard-routed row gathers for int64 fingerprints (lock
        held) and start their copies to the host; the gathers are fresh
        tensors, so the caller may release the lock before
        `_gather_rows_finish`."""
        h64 = np.asarray(h64, dtype=np.int64)
        grids = list(_hash_grid(h64, shard_of_hash(h64, self.n), self.n,
                                self.cfg.batch_size))
        parts: List[ShardedTensor] = []
        for hv, _ in grids:
            parts.extend(sharded_gather(self.shards, self.tables,
                                        self._parts(hv, 0), now,
                                        self.cfg.ways))
        return (self._fetch_later(*parts) if parts else None,
                [jv for _, jv in grids])

    def _gather_rows_finish(self, token, m: int):
        """(int64[10, m] in GATHER_ROW_FIELDS order, float64[m] remaining_f)
        assembled from each chunk's shard/lane placement grid."""
        pending, jvs = token
        out = np.zeros((len(GATHER_ROW_FIELDS), m), dtype=np.int64)
        rf = np.zeros(m, dtype=np.float64)
        if pending is None:
            return out, rf
        host = pending.wait()
        for i, jv in enumerate(jvs):
            a, f = host[2 * i], host[2 * i + 1]  # [n, 10, B], [n, B]
            at = jv >= 0
            out[:, jv[at]] = a.transpose(1, 0, 2)[:, at]
            rf[jv[at]] = f[at]
        return out, rf

    def _bulk_upsert(self, rows: List[dict], hashes: List[int],
                     now: int) -> None:
        """Route row dicts to their shards and upsert them with load_rows
        (lock held)."""
        self._bulk_upsert_into(self.tables, rows, hashes, now)

    def _bulk_upsert_into(self, tables, rows: List[dict],
                          hashes: List[int], now: int, route=None) -> None:
        """Upsert row dicts into `tables` with `route` (owner routing by
        default; the GlobalEngine seeds its cache replicas with arrival
        routing).  Caller holds the tables' lock."""
        if not rows:
            return
        h64 = _h64s(hashes)
        cols = [h64] + [
            np.array([r[f] for r in rows], dtype=_ROW_DTYPES[f])
            for f in BucketRows._fields[1:]
        ]
        shards = (route or (lambda h: shard_of_hash(h, self.n)))(h64)
        self._upsert_grid(tables, cols, shards, now)

    # -- state -----------------------------------------------------------
    def _columns_fetch(self, fields: Sequence[str], lo: int = 0,
                       n: Optional[int] = None, tables=None,
                       lock=None) -> PendingFetch:
        """Start copying columns [lo, lo + n) of the whole table (shard
        order) to the host: each shard's `fetch` of its stretch into its
        stretch of one set of host buffers, on its stream.  The buffers
        are allocated before `lock` (the auth tables' by default) is
        taken, so it is held only while the copies are queued."""
        if tables is None:
            tables, lock = self.tables, self._lock
        L = tables[0].key.shape[0]
        n = L * self.n - lo if n is None else n
        host = [self.shards[0].host_buffer(n, COLUMN_DTYPES[f])
                for f in fields]
        t0 = time.monotonic()
        with lock:
            parts = []
            for s, place in enumerate(self.shards):
                a, b = max(lo, s * L), min(lo + n, (s + 1) * L)
                if a >= b:
                    continue
                with place.on_stream():
                    parts.append(place.fetch(
                        [getattr(tables[s], f)[a - s * L:b - s * L]
                         for f in fields],
                        [h[a - lo:b - lo] for h in host]))
            pending = PendingFetch.join(
                parts, lambda: [h.numpy() for h in host])
        if tables is self.tables:
            self.last_copy_lock_s = time.monotonic() - t0
        return pending

    def _install_table(self, arrays: Dict[str, np.ndarray]) -> None:
        """Replace the live tables from host arrays (snapshot format):
        shard s takes its stretch, on its device."""
        if arrays["key"].shape[0] != self.cfg.num_slots:
            raise ValueError(
                f"snapshot has {arrays['key'].shape[0]} slots, backend "
                f"expects {self.cfg.num_slots}"
            )
        L = self.local_slots
        with self._lock:
            self.tables = _each(self.shards, lambda s: table_from_host(
                {f: a[s * L:(s + 1) * L] for f, a in arrays.items()},
                self.shards[s].device))

    def _occupancy_dispatch(self, tables) -> PendingFetch:
        """Live rows of each shard of `tables` (caller holds their lock)."""
        return self._fetch_later(_sharded(_each(
            self.shards, lambda s: tables[s].occupancy()), self.shards))

    def occupancy(self) -> int:
        return sum(self.shard_occupancy())

    def occupancy_dispatch(self):
        """Dispatch the resident-slot count under the lock; the returned
        closure fetches it (the tier manager's watermark read)."""
        with self._lock:
            pending = self._occupancy_dispatch(self.tables)
        return lambda: int(pending.wait()[0].sum())

    def shard_occupancy(self) -> List[int]:
        """Live rows PER SHARD: the skew view the aggregate occupancy()
        hides (/debug/vars `shard_occupancy`, gubernator_shard_occupancy)."""
        with self._lock:
            pending = self._occupancy_dispatch(self.tables)
        return [int(c) for c in pending.wait()[0]]

    # -- the state plane's dispatches (gubstat, the cold tier) -----------
    def table_stats_dispatch(self, shadow_fps: np.ndarray):
        """Dispatch the sharded census under the lock; the returned closure
        fetches a TableStats whose every leaf has one row per shard."""
        now = self.clock.millisecond_now()
        fps = np.asarray(shadow_fps, dtype=np.int64)
        with self._lock:
            st = sharded_table_stats(self.shards, self.tables,
                                     self._parts(fps, None), now,
                                     self.cfg.ways)
            pending = self._fetch_later(*st)
        return lambda: TableStats(*pending.wait())

    def demote_extract_dispatch(self, protect_fps: np.ndarray, batch: int):
        """Sharded demote: each shard gives its own `batch` coldest
        unprotected rows, so one dispatch yields n*batch candidates.  The
        fetch flattens the shards to the single-table contract:
        (int64[10, n*batch], float64[n*batch])."""
        now = self.clock.millisecond_now()
        fps = np.asarray(protect_fps, dtype=np.int64)
        with self._lock:
            packed, rf = sharded_demote_extract(
                self.shards, self.tables, self._parts(fps, None), now,
                self.cfg.ways, batch)
            pending = self._fetch_later(packed, rf)

        def fetch():
            p, r = pending.wait()
            return np.concatenate(list(p), axis=1), r.reshape(-1)

        return fetch

    def migrate_inject_dispatch(self, cols: Dict[str, np.ndarray]):
        """The promote path's inject: the generic migrate_inject_rows
        already serializes on the lock, so the whole probe + upsert +
        merge runs inside the returned fetch closure."""
        return lambda: self.migrate_inject_rows(cols)


def host_table(cols: Sequence[np.ndarray]) -> SlotTable:
    """Host column arrays in SlotTable field order -> a SlotTable of CPU
    tensors."""
    return SlotTable(*[torch.from_numpy(c) for c in cols])
