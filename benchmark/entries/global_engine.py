"""Entry module of GLOBAL behavior on the mesh: `GlobalEngine.serve_packed`
and `GlobalEngine.sync` over a `MeshBackend` with one shard a card, called
as the fast lane's engine lane calls them (runtime/fastpath.py
`_engine_process`): per call the checks' fingerprints aggregated by
`np.unique` (hits summed, one lane a key), `arrival_dev`,
`native.assign_rounds`, `_build_rounds`, the pending items and
`serve_packed`; per fetch the responses to the host, the tally, and each
check's answer from its key's lane.  The engine is built as
runtime/service.py builds it: `GlobalEngine(backend, batch_limit=1000)`,
collective psum, 256 delta slots.

The sync runs at the head of every call's dispatch, before its serve: the
collective loop's window (GlobalSyncWait, 500 us) closes between any two
calls at this rate, and the batch-limit trigger is taken there too, so
every answer depends on the seed and the call's index alone, whatever the
fetches' interleaving.  The clock is virtual: call g runs at t0 + g *
ms_per_call.

Set-up makes the traffic (benchmark/global_traffic.py), builds the engine,
runs its `warmup()` (an all-zero sync and an ingest at every tier: the
tables are unchanged) and populates with one permutation pass over the
keys through the same dispatch.  The check follows sampled (card, replica
bucket) pairs: every answer of a check on a key served there, populate and
window alike, and the rows of those buckets and of their keys'
authoritative buckets once the window has closed, against the plain
reference (reference/global_cluster.py).

On the card the shards go on cuda:0..n-1; on the CPU every shard is on the
CPU.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from benchmark import global_yardstick as gy
from benchmark.global_traffic import ZipfPool
from benchmark.reference import exact_table
from benchmark.reference import global_cluster as gc
from benchmark.yardstick import useful_bytes

ANSWER_FIELDS = gc.ANSWER_FIELDS


class Entry:
    kind = "global"

    def __init__(self, config: dict, mix: dict, seed: int, device: str,
                 log) -> None:
        self.config, self.mix, self.seed = config, mix, seed
        self.device, self.log = device, log
        self.traced = False
        self.traced_bytes = 0
        self.window_calls = 0
        self._rec: List[tuple] = []
        self._over: Dict[int, int] = {}
        self._rows: Optional[dict] = None
        self._owner_counts: List[int] = []

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        import torch

        from gubernator_tpu_torch import native
        from gubernator_tpu_torch.core.clock import Clock
        from gubernator_tpu_torch.core.config import DeviceConfig
        from gubernator_tpu_torch.parallel.global_sync import GlobalEngine
        from gubernator_tpu_torch.parallel.sharded import MeshBackend
        from gubernator_tpu_torch.runtime.metrics import Metrics

        t0 = time.perf_counter()
        t = self.t = ZipfPool(self.mix, self.config, self.seed, self.device)
        self.in_flight = t.in_flight
        self.h = native.hash_keys(t.hash_keys())
        geo = self.geo = gc.geometry(self.config)
        self.pairs = t.sample_pairs(self.h, geo, self.seed)
        self.follow = gc.Cluster(self.h, t.limit, t.duration, t.algo,
                                 self.pairs, geo, hits=t.hits)
        t1 = time.perf_counter()
        d, dep = self.config["device"], self.config["deployment"]
        tiers = d.get("batch_tiers")
        on_card = self.device.startswith("cuda")
        self.cfg = DeviceConfig(
            num_slots=int(d["num_slots"]), ways=int(d["ways"]),
            batch_size=int(d["batch_size"]),
            batch_tiers=tuple(tiers) if tiers else None,
            num_shards=geo.n,
            global_cache_slots=int(d["global_cache_slots"]),
            platform="cuda" if on_card else "cpu")
        devices = ([torch.device("cuda", i) for i in range(geo.n)]
                   if on_card else None)
        self.clock = Clock()
        self.clock.freeze(t.t0_ms * 10**6)
        self.be = MeshBackend(self.cfg, clock=self.clock, devices=devices,
                              metrics=Metrics())
        self.eng = GlobalEngine(self.be,
                                delta_slots=int(dep["delta_slots"]),
                                batch_limit=int(dep["batch_limit"]),
                                collective=dep["collective"])
        self.eng.warmup()
        pending = []
        for g in range(t.populate_calls):
            pending.append(self._begin(g))
            if len(pending) == self.in_flight:
                self._end(pending.pop(0))
        while pending:
            self._end(pending.pop(0))
        self.be.synchronize()
        self.log(f"set-up: traffic and sample {t1 - t0:.3f} s "
                 f"({len(self.pairs)} pairs), engine and populate "
                 f"({t.populate_calls} calls) "
                 f"{time.perf_counter() - t1:.3f} s; shards on "
                 f"{self.be.shard_devices}")

    # -- calls -----------------------------------------------------------
    def _begin(self, g: int):
        """Global call g: the sync of the queue, then the call's serve."""
        from gubernator_tpu_torch import native
        from gubernator_tpu_torch.core.types import Behavior, RateLimitReq
        from gubernator_tpu_torch.parallel.global_sync import arrival_dev
        from gubernator_tpu_torch.parallel.mesh import shard_of_hash
        from gubernator_tpu_torch.runtime.fastpath import _build_rounds

        t, n, B = self.t, self.geo.n, self.cfg.batch_size
        ids = t.call_ids(g)
        self.clock.freeze(t.now_ms(g) * 10**6)
        synced = self._owner_counts
        self.eng.sync()
        h = self.h[ids]
        uniq, first, inv = np.unique(h, return_index=True,
                                     return_inverse=True)
        rep = ids[first]
        m = len(uniq)
        hits = np.zeros(m, dtype=np.int64)
        np.add.at(hits, inv, t.hits)
        lim = t.limit[rep]
        sh = arrival_dev(uniq, n).astype(np.int32)
        rnd, lane, n_rounds = native.assign_rounds(uniq, sh, n, B)
        off = np.zeros(m, dtype=np.int64)
        values = dict(
            key_hash=uniq, hits=hits, limit=lim, duration=t.duration[rep],
            algo=t.algo[rep], burst=lim,
            reset_remaining=np.zeros(m, dtype=bool),
            is_greg=np.zeros(m, dtype=bool), greg_expire=off,
            greg_duration=off, use_cached=np.ones(m, dtype=bool))
        rounds, order, bounds = _build_rounds(values, rnd, lane, n_rounds,
                                              B, sh, n)
        glob = int(Behavior.GLOBAL)
        pend = [(RateLimitReq(name=t.name, unique_key=t.prefix + str(k),
                              hits=t.hits, limit=li, duration=du,
                              algorithm=al, behavior=glob, burst=li), hs, s)
                for k, hs, li, du, al, s in zip(
                    rep.tolist(), hits.tolist(), lim.tolist(),
                    t.duration[rep].tolist(), t.algo[rep].tolist(),
                    sh.tolist())]
        resps, _ = self.eng.serve_packed(rounds, pend)
        self._owner_counts = np.bincount(
            shard_of_hash(uniq, n).astype(np.int64), minlength=n).tolist()
        return (g, ids, inv, sh, lane, order, bounds, n_rounds, rounds,
                resps, getattr(self.eng, "calls", None), synced)

    def _fetch_host(self, resps, call):
        fetch = getattr(self.eng, "fetch_packed", None)
        if fetch is not None:
            return fetch(resps, call)
        from gubernator_tpu_torch.parallel.sharded import (
            packed_grid_rounds_to_host,
        )
        return packed_grid_rounds_to_host(resps) if resps is not None else []

    def _end(self, token) -> int:
        from gubernator_tpu_torch.runtime.backend import (
            Tally,
            tally_from_rounds,
        )

        (g, ids, inv, sh, lane, order, bounds, n_rounds, rounds, resps,
         call, synced) = token
        host = self._fetch_host(resps, call)
        m = sh.size
        cols = {f: np.zeros(m, dtype=np.int64)
                for f in ANSWER_FIELDS + ("found", "persisted", "cached")}
        for r in range(n_rounds):
            sel = order[bounds[r]:bounds[r + 1]]
            at = (sh[sel], lane[sel])
            for f, v in cols.items():
                v[sel] = host[r][f][at]
        tl = tally_from_rounds(rounds, host)
        self.be._add_tally(Tally(
            checks=m, over_limit=int((cols["status"] == 1).sum()),
            not_persisted=tl.not_persisted, cache_hits=tl.cache_hits))
        answers = np.stack([cols[f] for f in ANSWER_FIELDS], axis=1)[inv]
        pos = np.flatnonzero(self.follow.is_serve[ids])
        if pos.size:
            self._rec.append((g, pos, answers[pos]))
        self._over[g] = int(np.count_nonzero(answers[:, 0] == 1))
        if self.traced:
            written = (cols["persisted"] != 0) & (cols["cached"] == 0)
            self.traced_bytes += useful_bytes(
                n_rounds, m, int(np.count_nonzero(cols["found"])),
                int(np.count_nonzero(written)), self.geo.ways)
            self.traced_bytes += gy.sync_bytes(
                gy.chunk_keys(synced, self.geo.delta_slots), self.geo.n,
                self.geo.delta_slots, self.geo.ways)
        return len(ids)

    def dispatch(self, i: int):
        """Start window call i."""
        self.window_calls = max(self.window_calls, i + 1)
        return self._begin(self.t.populate_calls + i)

    def fetch(self, token) -> int:
        """Finish a call; returns the checks it answered."""
        return self._end(token)

    # -- the check -------------------------------------------------------
    def read_state(self) -> None:
        """Copy back the sampled replica buckets from each card and their
        keys' authoritative buckets from their owners."""
        import torch

        ways, geo = self.geo.ways, self.geo
        if self.device.startswith("cuda"):
            peaks = [torch.cuda.max_memory_allocated(p.device)
                     for p in self.be.shards]
            self.log(f"device memory peak per card: {peaks} B")

        def read(tables, shard, buckets):
            slots = (np.asarray(buckets, np.int64)[:, None] * ways
                     + np.arange(ways)).reshape(-1)
            tab = tables[shard]
            idx = torch.from_numpy(slots).to(tab.key.device)
            return {f: getattr(tab, f)[idx].cpu().numpy().reshape(-1, ways)
                    for f in exact_table.ROW_FIELDS}

        def gather(tables, where):
            out = {f: np.zeros((len(where), ways),
                               dtype=np.float64 if f == "remaining_f"
                               else np.int64)
                   for f in exact_table.ROW_FIELDS}
            for s in range(geo.n):
                at = [j for j, (c, _) in enumerate(where) if c == s]
                if not at:
                    continue
                got = read(tables, s, [where[j][1] for j in at])
                for f in out:
                    out[f][at] = got[f]
            return out

        codes = self.follow.auth_codes.tolist()
        self._rows = {
            "replica": gather(self.eng.cache_tables, self.pairs),
            "auth": gather(self.be.tables, [(a // geo.nb_auth,
                                             a % geo.nb_auth)
                                            for a in codes])}

    def free(self) -> None:
        import torch

        self.eng = self.be = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _reference(self, fdt):
        """The reference's answers on the followed checks, as
        (int64[m, 2] of (call, position), int64[m, 4]), and its rows."""
        t = self.t
        cl = gc.Cluster(self.h, t.limit, t.duration, t.algo, self.pairs,
                        self.geo, fdt, hits=t.hits)
        keys, answers = [], []
        for g in range(t.populate_calls + self.window_calls):
            pos, a = cl.call(t.call_ids(g), t.now_ms(g))
            if pos.size:
                keys.append(np.stack([np.full(pos.size, g), pos], axis=1))
                answers.append(a)
        return (_cat(keys, 2), _cat(answers, 4),
                {"replica": cl.rep_rows(), "auth": cl.auth_rows()})

    def _program_answers(self):
        keys = _cat([np.stack([np.full(p.size, g), p], axis=1)
                     for g, p, _ in self._rec], 2)
        answers = _cat([a for _, _, a in self._rec], 4)
        order = np.lexsort((keys[:, 1], keys[:, 0]))
        return keys[order], answers[order]

    def verify(self) -> Dict[str, tuple]:
        """The compared numbers, each with its limit: followed answers and
        rows (replica and authoritative) that differ from the
        reference's."""
        keys_r, ans_r, rows_r = self._reference(np.float64)
        keys_p, ans_p = self._program_answers()
        if keys_p.shape != keys_r.shape or not np.array_equal(keys_p,
                                                              keys_r):
            wrong = max(len(keys_p), len(keys_r))
        else:
            wrong = int(np.count_nonzero((ans_p != ans_r).any(axis=1)))
        out = {"answers_wrong": (wrong, 0)}
        for part in ("replica", "auth"):
            bad = np.zeros(rows_r[part]["key"].shape, dtype=bool)
            for f in exact_table.ROW_FIELDS:
                bad |= self._rows[part][f] != rows_r[part][f]
            out[f"{part}_rows_wrong"] = (int(np.count_nonzero(bad)), 0)
        P, W = self.t.populate_calls, self.window_calls
        over = np.array([self._over.get(P + i, 0) for i in range(W)])
        tenth = np.arange(W) * 10 // max(W, 1)
        share = [100 * over[tenth == k].sum()
                 / max(self.t.lanes * int((tenth == k).sum()), 1)
                 for k in range(10)]
        self.log(f"check: {len(keys_r)} followed answers over "
                 f"{len(self.pairs)} (card, replica bucket) pairs and "
                 f"{len(self.follow.auth_codes)} authoritative buckets, "
                 f"{P} populate and {W} window calls; % over limit in each "
                 f"tenth of the window: "
                 + " ".join(f"{s:.1f}" for s in share))
        return out


def _cat(parts, width: int) -> np.ndarray:
    return (np.concatenate(parts) if parts
            else np.zeros((0, width), dtype=np.int64))


class Control(Entry):
    """The check's control: the run as the cell makes it, with the
    program's followed answers and rows put aside once the window has
    closed and the plain reference's, computed with the leaky bucket's
    arithmetic in float32 (the configuration states float64), put in
    their place; `verify()` judges them as it judges the program's."""

    def read_state(self) -> None:
        super().read_state()
        keys, answers, rows = self._reference(np.float32)
        self._answers = keys, answers
        self._rows = rows

    def _program_answers(self):
        return self._answers
