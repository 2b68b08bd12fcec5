"""The sharded slot table on one card: the mesh engine.

The JAX package shards the slot table's slot axis over a device mesh; each
device owns `num_slots / n` slots and is the single writer for the keys that
hash to it — the single-writer-by-placement discipline of the reference
worker pool (workers.go:19-37) and peer ring (architecture.md:13-17).  Here
the `shard` axis is a leading index over contiguous column slices of ONE
table (parallel/mesh.shard_view), so the layout is the JAX mesh's word for
word and `snapshot()` equals its `table_to_host`.

The JAX lifts (`shard_map` of one single-table body) become plain functions
that loop over the shards and call the port's single-table function on that
shard's views:

    JAX lift                          here                  on the card
    make_sharded_step_packed,
    make_mesh_ring_step,
    make_mesh_mega_ring_step          mesh_ring_step        K1 once a shard
    make_sharded_row_op               sharded_row_op        load_rows /
                                                            store_cached_rows
    make_sharded_probe                sharded_probe         probe_batch
    make_sharded_gather               sharded_gather        gather_rows
    make_sharded_demote_extract       sharded_demote_extract demote_extract
    make_sharded_table_stats          sharded_table_stats   table_stats

(megaround's r x s rounds go out as one mesh_ring_step of r*s rounds, as
the single-table backend's do).  Every single-table op updates its table in
place, so a call on a shard's
views writes the base columns.  The hot path needs no collective: routing
already placed every request on its owner shard.  A dispatch of `n` shards
is `n` launches of K1 on the backend's one stream.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.core import clock as clock_mod
from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.core.hashing import key_hash64
from gubernator_tpu_torch.core.types import RateLimitReq
from gubernator_tpu_torch.ops.batch import (
    PackedGrid,
    pack_batch_q,
    pack_requests_grid,
)
from gubernator_tpu_torch.ops.kernels import serve_kernel
from gubernator_tpu_torch.ops.kernels.serve_kernel import new_claim_buffer
from gubernator_tpu_torch.ops.state import (
    SlotTable,
    TableStats,
    demote_extract,
    init_table,
    table_stats,
)
from gubernator_tpu_torch.ops.step import (
    GATHER_ROW_FIELDS,
    BucketRows,
    CachedRows,
    gather_rows,
    load_rows,
    probe_batch,
    store_cached_rows,
)
from gubernator_tpu_torch.parallel.mesh import (
    claim_view,
    shard_of_hash,
    shard_view,
)
from gubernator_tpu_torch.runtime.backend import (
    _ROW_DTYPES,
    PendingFetch,
    TorchDeviceHost,
    _h64s,
    packed_rounds_to_host,
    resolve_tiers,
)


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


# -- the lifts ------------------------------------------------------------
def mesh_ring_step(
    table: SlotTable,
    qs: torch.Tensor,    # int64[k, 12, n, B]
    nows: torch.Tensor,  # int64[k]
    seq: torch.Tensor,   # int64[n] per-shard sequence words
    n: int,
    ways: int = 8,
    claim: Optional[torch.Tensor] = None,
    scratch: Optional[torch.Tensor] = None,
):
    """k packed rounds on every shard: (table, int64[k, n, 9, B], seq + k).

    Shard s runs the serve kernel (ops/kernels/serve_kernel.py; its plain
    `ring_step` on the CPU) on its own views and its [k, 12, B] block, so a
    mesh step is one single-table step per shard by construction.  The
    block is made shard-major with one device copy, so each shard's block
    is contiguous.  `scratch` is reused shard after shard in stream
    order."""
    q = qs.permute(2, 0, 1, 3).contiguous()
    resps, seqs = [], []
    for s in range(n):
        _, r, sq = serve_kernel.persistent_serve_step(
            shard_view(table, s, n), q[s], nows, seq[s:s + 1], ways,
            claim=claim_view(claim, s, n), scratch=scratch,
        )
        resps.append(r)
        seqs.append(sq)
    return table, torch.stack(resps, dim=1), torch.cat(seqs)


def sharded_row_op(op: Callable, table: SlotTable, rows, now, n: int,
                   ways: int = 8) -> SlotTable:
    """Row upserts on every shard: `op` (ops/step.load_rows — Loader
    restore, Store seeding — or store_cached_rows — the GLOBAL broadcast
    receive) on shard s's views with the [B] rows `rows[...][s]` of an
    [n, B] grid."""
    for s in range(n):
        op(shard_view(table, s, n), type(rows)(*[a[s] for a in rows]),
           now, ways)
    return table


def sharded_probe(table: SlotTable, h: torch.Tensor, now, n: int,
                  ways: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read-only lookup of an [n, B] fingerprint grid: (found bool[n, B],
    shard-local slot int64[n, B])."""
    out = [probe_batch(shard_view(table, s, n), h[s], now, ways)
           for s in range(n)]
    return (torch.stack([f for f, _ in out]),
            torch.stack([sl for _, sl in out]))


def sharded_gather(table: SlotTable, h: torch.Tensor, now, n: int,
                   ways: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row read-back of an [n, B] fingerprint grid: (int64[n, 10, B] in
    GATHER_ROW_FIELDS order, float64[n, B] remaining_f)."""
    out = [gather_rows(shard_view(table, s, n), h[s], now, ways)
           for s in range(n)]
    return (torch.stack([p for p, _ in out]),
            torch.stack([rf for _, rf in out]))


def sharded_demote_extract(table: SlotTable, protect: torch.Tensor, now,
                           n: int, ways: int = 8, batch: int = 64):
    """Tier demotion on every shard: each picks its own `batch` coldest
    unprotected rows on its slice (victim choice is slice-local, as the
    bucket-local pseudo-LRU is bucket-local) and clears them.  The protect
    list is shared: a shadow key only matches on its home shard.  Returns
    (table, int64[n, 10, batch], float64[n, batch])."""
    out = [demote_extract(shard_view(table, s, n), protect, now, ways, batch)
           [1:] for s in range(n)]
    return (table, torch.stack([p for p, _ in out]),
            torch.stack([rf for _, rf in out]))


def sharded_table_stats(table: SlotTable, shadow_fps: torch.Tensor, now,
                        n: int, ways: int = 8) -> TableStats:
    """The gubstat census on every shard, each leaf stacked on a leading
    [n] axis: per-shard occupancy for free, sums for totals.  A derived key
    only matches on its home shard, so per-class sums are exact."""
    out = [table_stats(shard_view(table, s, n), shadow_fps, now, ways)
           for s in range(n)]
    return TableStats(*[torch.stack(leaf) for leaf in zip(*out)])


class MeshBackend(TorchDeviceHost):
    """The JAX package's MeshBackend on one torch device: the table split
    into `cfg.num_shards` shards, each served through K1 on its views."""

    def __init__(
        self,
        cfg: DeviceConfig,
        clock=None,
        metrics=None,
        store=None,
        track_keys: bool = False,
    ) -> None:
        if cfg.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.cfg = cfg
        self.clock = clock or clock_mod.default_clock()
        self.metrics = metrics
        self.store = store
        self._keymap: Optional[Dict[int, str]] = (
            {} if (store is not None or track_keys) else None
        )
        self._init_write_through()
        self._init_device()
        self.n = cfg.num_shards
        self.local_slots = cfg.num_slots // self.n
        nb_local = self.local_slots // cfg.ways
        if nb_local & (nb_local - 1):
            raise ValueError(
                f"buckets per shard ({nb_local}) must be a power of two"
            )
        self.table, self.claim = self.new_table(cfg.num_slots)
        self._tiers = resolve_tiers(cfg)
        self.checks = 0
        self.over_limit = 0
        self.not_persisted = 0

    def new_table(self, num_slots: int):
        """(an empty table of `num_slots` slots on the backend's device, its
        claim-word buffer — None on the CPU).  The GlobalEngine's cache
        table is made here too: each table owns one claim buffer, sliced
        per shard."""
        with self._on_stream():
            return (init_table(num_slots, self.device),
                    new_claim_buffer(num_slots, self.device)
                    if self.stream is not None else None)

    def _pack(self, reqs, use_cached=None):
        return pack_requests_sharded(
            reqs, self.cfg.batch_size, self.n, self.clock, use_cached)

    def _launch(self, qs, nows, seq, table: Optional[SlotTable] = None,
                claim: Optional[torch.Tensor] = None):
        """One mesh dispatch of `qs` int64[k, 12, n, B] (one upload): K1
        once per shard, on `table` (the auth table by default) and its
        claim buffer.  Caller holds the table's lock.  Returns the
        un-synced (int64[k, n, 9, B], seq + k per shard)."""
        if table is None:
            table, claim = self.table, self.claim
        with self._on_stream():
            qs = self._upload(qs)
            nows = self._upload(nows).contiguous()
            if not isinstance(seq, torch.Tensor):
                seq = np.full(self.n, seq, dtype=np.int64)
            seq = self._upload(seq)
            scratch = None
            if self.stream is not None and qs.shape[0]:
                scratch = self._scratch_for(qs.shape[0], qs.shape[3])
            _, resps, seq = mesh_ring_step(
                table, qs, nows, seq, self.n, self.cfg.ways, claim, scratch)
        return resps, seq

    # -- ring drain discipline (runtime/ring.py) -------------------------
    def ring_q_shape(self, tb: int) -> tuple:
        """Per-round request-slot shape at batch tier `tb`: the grid form
        [12, n_shards, tb]."""
        return (12, self.n, tb)

    def ring_seq_init(self) -> torch.Tensor:
        """Fresh per-shard sequence words (int64[n])."""
        with self._on_stream():
            return torch.zeros(self.n, dtype=torch.int64, device=self.device)

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
            with self._on_stream():
                h = self._upload(zeros)
                sharded_probe(self.table, h, now, n, self.cfg.ways)
                sharded_gather(self.table, h, now, n, self.cfg.ways)
                rows = BucketRows(*self._upload_cols([
                    np.zeros((n, B), dtype=_ROW_DTYPES[f])
                    for f in BucketRows._fields]))
                sharded_row_op(load_rows, self.table, rows, now, n,
                               self.cfg.ways)
        self.table_stats_dispatch(np.zeros((5, 8), dtype=np.int64))()
        if self.stream is not None:
            self.stream.synchronize()

    # -- GLOBAL broadcast receive ----------------------------------------
    def apply_cached_rows(self, rows: Sequence[tuple]) -> None:
        """Upsert owner-broadcast statuses, routed to their shards: rows of
        (hash_key_str, algorithm, limit, remaining, status, reset_time)."""
        self._note_keys([c[0] for c in rows])
        if not rows:
            return
        h64 = _h64s([key_hash64(c[0]) for c in rows])
        cols = [h64] + [
            np.array([c[i] for c in rows], dtype=dt)
            for i, dt in ((1, np.int32), (2, np.int64), (3, np.int64),
                          (4, np.int32), (5, np.int64))
        ]
        now = self.clock.millisecond_now()
        with self._lock:
            self._upsert_grid(self.table, store_cached_rows, CachedRows,
                              cols, shard_of_hash(h64, self.n), now)

    def _upsert_grid(self, table, op, row_type, cols, shards, now):
        """`op` over `row_type` rows given as host columns, drained into
        [n, B] grids by `shards`; caller holds the table's lock."""
        n, B = self.n, self.cfg.batch_size
        with self._on_stream():
            for sel, s, lane in drain_to_grids(shards, n, B):
                grid = []
                for c in cols:
                    g = np.zeros((n, B), dtype=c.dtype)
                    g[s, lane] = c[sel]
                    grid.append(g)
                sharded_row_op(op, table, row_type(*self._upload_cols(grid)),
                               now, n, self.cfg.ways)
        return table

    # -- point reads / persistence ---------------------------------------
    def bucket_offset(self, key: str) -> int:
        """Row index of `key`'s bucket within its owner shard's block."""
        h = key_hash64(key)
        nb_local = self.local_slots // self.cfg.ways
        shard = int(shard_of_hash(h, self.n))
        return shard * self.local_slots + (h & (nb_local - 1)) * self.cfg.ways

    def _probe_grid(self, keys, hashes, now: int,
                    table: Optional[SlotTable] = None, route=None):
        """Shard-routed batched probes: (found, global slot) per key, in
        key order, one fetch for every chunk (lock held).  `table`/`route`
        default to the auth table with owner routing; the GlobalEngine
        passes its cache table with arrival routing.  The table's geometry
        may differ from the auth table's (global_cache_slots)."""
        if table is None:
            table = self.table
        n = self.n
        local = table.key.shape[0] // n
        h64 = _h64s(hashes)
        shards = (route or (lambda h: shard_of_hash(h, n)))(h64)
        found = np.zeros(len(keys), dtype=bool)
        gslot = np.zeros(len(keys), dtype=np.int64)
        grids = list(_hash_grid(h64, shards, n, self.cfg.batch_size))
        if not grids:
            return found, gslot
        outs: List[torch.Tensor] = []
        with self._on_stream():
            for hv, _ in grids:
                outs.extend(sharded_probe(table, self._upload(hv), now, n,
                                          self.cfg.ways))
            host = PendingFetch(outs, self.stream).wait()
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
        parts: List[torch.Tensor] = []
        with self._on_stream():
            for hv, _ in grids:
                parts.extend(sharded_gather(
                    self.table, self._upload(hv), now, self.n,
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
        self.table = self._bulk_upsert_into(self.table, rows, hashes, now)

    def _bulk_upsert_into(self, table: SlotTable, rows: List[dict],
                          hashes: List[int], now: int,
                          route=None) -> SlotTable:
        """Upsert row dicts into `table` with `route` (owner routing by
        default; the GlobalEngine seeds its cache table with arrival
        routing).  Caller holds the table's lock."""
        if not rows:
            return table
        h64 = _h64s(hashes)
        cols = [h64] + [
            np.array([r[f] for r in rows], dtype=_ROW_DTYPES[f])
            for f in BucketRows._fields[1:]
        ]
        shards = (route or (lambda h: shard_of_hash(h, self.n)))(h64)
        return self._upsert_grid(table, load_rows, BucketRows, cols, shards,
                                 now)

    def shard_occupancy(self) -> List[int]:
        """Live rows PER SHARD: the skew view the aggregate occupancy()
        hides (/debug/vars `shard_occupancy`, gubernator_shard_occupancy)."""
        with self._lock, self._on_stream():
            counts = (self.table.key.view(self.n, self.local_slots) != 0
                      ).sum(dim=1)
            return [int(c) for c in counts.cpu()]

    # -- the state plane's dispatches (gubstat, the cold tier) -----------
    def table_stats_dispatch(self, shadow_fps: np.ndarray):
        """Dispatch the sharded census under the lock; the returned closure
        fetches a TableStats whose every leaf has one row per shard."""
        now = self.clock.millisecond_now()
        fps = np.asarray(shadow_fps, dtype=np.int64)
        with self._lock, self._on_stream():
            st = sharded_table_stats(self.table, self._upload(fps), now,
                                     self.n, self.cfg.ways)
            pending = PendingFetch(list(st), self.stream)
        return lambda: TableStats(*pending.wait())

    def demote_extract_dispatch(self, protect_fps: np.ndarray, batch: int):
        """Sharded demote: each shard gives its own `batch` coldest
        unprotected rows, so one dispatch yields n*batch candidates.  The
        fetch flattens the shards to the single-table contract:
        (int64[10, n*batch], float64[n*batch])."""
        now = self.clock.millisecond_now()
        fps = np.asarray(protect_fps, dtype=np.int64)
        with self._lock, self._on_stream():
            _, packed, rf = sharded_demote_extract(
                self.table, self._upload(fps), now, self.n, self.cfg.ways,
                batch)
            pending = PendingFetch([packed, rf], self.stream)

        def fetch():
            p, r = pending.wait()
            return np.concatenate(list(p), axis=1), r.reshape(-1)

        return fetch

    def migrate_inject_dispatch(self, cols: Dict[str, np.ndarray]):
        """The promote path's inject: the generic migrate_inject_rows
        already serializes on the lock, so the whole probe + upsert +
        merge runs inside the returned fetch closure."""
        return lambda: self.migrate_inject_rows(cols)

