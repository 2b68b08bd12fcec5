"""GLOBAL behavior on a cluster of n peers, plainly: gubernator's
global.go:33-254 and gubernator.go:420-479 as the collective engine
implements them, one peer a shard.

Every peer keeps a replica of the GLOBAL serving cache (a W-way table of its
own) and owns a shard of the authoritative table.  A call's checks are
aggregated by key (hits summed; duplicates share their key's answer), the
distinct keys taken in ascending (signed) fingerprint order, and each key is
served on its arrival peer, from that peer's replica (a peer's j-th key in
lane j mod batch_size of serve round j div batch_size, rounds in order):

- a live row that an owner broadcast answers verbatim (status, limit,
  remaining, and its expire_at as reset_time) and is left as it is;
- otherwise the key is processed locally "like we own it": the token or
  leaky bucket algebra on the replica's own row (exact_table.decide), which
  is written back as a bucket row;

and its summed hits are queued for its owner.  At the next sync (at the head
of the next call, at that call's clock) the queued keys, in the order they
were queued, take lanes per owner (key j of an owner is lane j mod D of
chunk j div D).  Chunk after chunk, each owner applies its lanes to its
authoritative shard as two rounds (the summed hits, then the same lanes with
hits 0: exact_table.apply_round), and the second round's answer is the
key's broadcast row (key, algorithm, limit, remaining, status, reset_time);
every replica then stores every broadcast row of the chunk, owner by owner
and lane by lane, as a cached row with expire_at = reset_time.

A bucket's lookup and claims are exact_table's: a key matches a live row
holding its fingerprint; a key that matches none claims a victim way (its
own expired way, then an empty one, then another expired one, then the least
recently touched, ties to the lowest way), in up to three claim rounds in
which the lowest lane wins; a lane left without a way is answered and
leaves no row.  A cached hit reserves its way and does not touch it.

The owner also serves from its replica (the engine's documented deviation
from gubernator.go:272-283).  Routing, from the key's 64-bit fingerprint:
owner (fingerprint >> 32) mod n, arrival peer (fingerprint >> 44) mod n,
bucket the fingerprint's low bits in each table.

Only sampled (peer, replica bucket) pairs are followed.  A replica bucket's
rows depend on the serves of its keys that arrive there and on the broadcast
rows of every key of that bucket; those come from the keys' authoritative
buckets, which depend only on the traffic and the sync schedule (the queued
hits follow the requests, never the answers).  So the closure is two levels
deep: the authoritative buckets of the sampled buckets' keys, with every key
of theirs, are simulated in full.  `fdt` is the leaky bucket's floating
type (float64 as the configuration states; the control passes float32).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from benchmark.reference import exact_table as et

KIND_CACHED = 1
ANSWER_FIELDS = ("status", "limit", "remaining", "reset_time")


class Geometry(NamedTuple):
    n: int          # peers (shards)
    ways: int
    nb_auth: int    # buckets of an owner's authoritative shard
    nb_rep: int     # buckets of a peer's replica
    delta_slots: int  # lanes an owner takes a sync chunk
    batch_size: int   # lanes a peer takes a serve round


def geometry(config: dict) -> Geometry:
    d = config["device"]
    n, ways = int(config["num_shards"]), int(d["ways"])
    return Geometry(n, ways, int(d["num_slots"]) // n // ways,
                    int(d["global_cache_slots"]) // n // ways,
                    int(config["deployment"]["delta_slots"]),
                    int(d["batch_size"]))


def _u(h) -> np.ndarray:
    return np.asarray(h, dtype=np.int64).view(np.uint64) \
        if np.ndim(h) else np.uint64(np.int64(h).view(np.uint64))


def owner(h, n: int):
    return (_u(h) >> np.uint64(32)) % np.uint64(n)


def arrival(h, n: int):
    return (_u(h) >> np.uint64(44)) % np.uint64(n)


def auth_bucket(h, geo: Geometry):
    return np.asarray(h, dtype=np.int64) & np.int64(geo.nb_auth - 1)


def rep_bucket(h, geo: Geometry):
    return np.asarray(h, dtype=np.int64) & np.int64(geo.nb_rep - 1)


def locate(rows: List[list], keys: Sequence[int], now: int) -> List[tuple]:
    """(way or -1, found) of each lane's key (distinct, in lane order) in
    one bucket: exact_table.apply_round's lookup and claims."""
    W = len(rows)
    looks, reserved = [], set()
    for h in keys:
        match, vscore = -1, []
        for w, row in enumerate(rows):
            mine = row[et.KEY] == h
            live = row[et.EXPIRE] > now
            if mine and live and match < 0:
                match = w
            klass = (0 if mine and not live else 1 if row[et.KEY] == 0
                     else 2 if not live else 3)
            vscore.append(klass * (1 << 48) + row[et.TOUCHED])
        if match >= 0:
            reserved.add(match)
        looks.append((match, vscore))
    slot = [m for m, _ in looks]
    for _ in range(et.INSERT_ROUNDS):
        wants: Dict[int, int] = {}
        for i, (match, vscore) in enumerate(looks):
            if match >= 0 or slot[i] >= 0:
                continue
            best, at = et._INF, -1
            for w in range(W):
                if w not in reserved and vscore[w] < best:
                    best, at = vscore[w], w
            if at >= 0 and at not in wants:
                wants[at] = i
        for w, i in wants.items():
            slot[i] = w
            reserved.add(w)
    return [(s, m >= 0) for s, (m, _) in zip(slot, looks)]


def serve_round(rows: List[list], reqs: Sequence[tuple], now: int,
                fdt=np.float64) -> List[tuple]:
    """One call's lanes of one replica bucket (lane order, keys distinct;
    a req is exact_table's (h, hits, limit, duration, algo, burst,
    reset)): a live cached row answers verbatim, any other lane takes the
    bucket algebra on the replica's row.  Returns each lane's answer."""
    out, writes = [], []
    for req, (s, found) in zip(reqs, locate(rows, [r[0] for r in reqs],
                                             now)):
        row = rows[s] if found else et.empty_row()
        if found and row[et.KIND] == KIND_CACHED:
            out.append((row[et.STATUS], row[et.LIMIT], row[et.REMAINING],
                        row[et.EXPIRE]))
            continue
        ans, new = et.decide(row, found, req, now, fdt)
        out.append(ans)
        if s >= 0:
            writes.append((s, new))
    for s, new in writes:
        rows[s] = new
    return out


def store_cached(rows: List[list], bcast: Sequence[tuple],
                 now: int) -> None:
    """Store broadcast rows (h, algo, limit, remaining, status, reset_time),
    in lane order and keys distinct, into one replica bucket."""
    for b, (s, _) in zip(bcast, locate(rows, [x[0] for x in bcast], now)):
        if s >= 0:
            h, algo, lim, rem, st, reset = b
            rows[s] = [h, algo, KIND_CACHED, lim, 0, rem, 0.0, 0, st, 0,
                       reset, now]


class Cluster:
    """The sampled pairs' replica buckets and their closure's authoritative
    buckets, stepped call by call."""

    def __init__(self, h: np.ndarray, limit: np.ndarray,
                 duration: np.ndarray, algo: np.ndarray,
                 pairs: Sequence[Tuple[int, int]], geo: Geometry,
                 fdt=np.float64, hits: int = 1) -> None:
        self.h, self.geo, self.fdt = np.asarray(h, np.int64), geo, fdt
        self.hits = int(hits)  # a check's hits
        self.limit = np.asarray(limit, np.int64)
        self.duration = np.asarray(duration, np.int64)
        self.algo = np.asarray(algo, np.int64)
        n = geo.n
        self.own = owner(self.h, n).astype(np.int64)
        self.arr = arrival(self.h, n).astype(np.int64)
        self.ab = auth_bucket(self.h, geo)
        self.rb = rep_bucket(self.h, geo)
        self.pairs = sorted(set(pairs))
        self.cards_of: Dict[int, List[int]] = {}
        for c, b in self.pairs:
            self.cards_of.setdefault(b, []).append(c)
        # K1: every key of a sampled replica bucket; the serve keys among
        # them arrive on a sampled card; K2: every key of their
        # authoritative buckets.
        k1 = np.isin(self.rb, np.fromiter(self.cards_of, np.int64))
        pair_code = {c * geo.nb_rep + b for c, b in self.pairs}
        code = self.arr * geo.nb_rep + self.rb
        self.is_serve = k1 & np.isin(code, np.fromiter(pair_code, np.int64))
        self.in_k1 = k1
        abc = self.own * geo.nb_auth + self.ab
        self.auth_codes = np.unique(abc[k1])
        self.in_k2 = np.isin(abc, self.auth_codes)
        self.rep = {p: [et.empty_row() for _ in range(geo.ways)]
                    for p in self.pairs}
        self.auth = {int(a): [et.empty_row() for _ in range(geo.ways)]
                     for a in self.auth_codes}
        self.queued: List[tuple] = []  # (chunk, owner, lane, key, hits)

    def _req(self, k: int, hits: int) -> tuple:
        lim = int(self.limit[k])
        return (int(self.h[k]), hits, lim, int(self.duration[k]),
                int(self.algo[k]), lim, 0)

    def _distinct(self, ids: np.ndarray):
        """The call's distinct keys in ascending (signed) fingerprint order,
        the order the call gives them lanes and queues them, with their
        checks' summed hits."""
        uniq, counts = np.unique(ids, return_counts=True)
        order = np.argsort(self.h[uniq], kind="stable")
        return uniq[order], counts[order] * self.hits

    def _rank(self, peer: np.ndarray) -> np.ndarray:
        """Each key's index among the keys before it that go to the same
        peer."""
        rank = np.empty(peer.size, np.int64)
        for o in range(self.geo.n):
            at = peer == o
            rank[at] = np.arange(int(at.sum()))
        return rank

    def _queue(self, uniq: np.ndarray, hits: np.ndarray) -> None:
        """The call's keys queued for their owners, with their lanes: key j
        of an owner in queue order takes lane j mod D of chunk j div D."""
        own = self.own[uniq]
        rank = self._rank(own)
        D = self.geo.delta_slots
        self.queued = [(int(rank[j] // D), int(own[j]), int(rank[j] % D),
                        int(uniq[j]), int(hits[j]))
                       for j in np.flatnonzero(self.in_k2[uniq])]

    def _sync(self, now: int) -> None:
        """The queued keys to their owners, chunk by chunk: the owners'
        two-round apply, then every replica stores the broadcast rows."""
        if not self.queued:
            return
        for chunk in sorted({q[0] for q in self.queued}):
            by_bucket: Dict[int, list] = {}
            for c, o, lane, k, hits in self.queued:
                if c == chunk:
                    code = o * self.geo.nb_auth + int(self.ab[k])
                    by_bucket.setdefault(code, []).append((lane, k, hits))
            bcast: Dict[int, list] = {}
            for code, lanes in by_bucket.items():
                lanes.sort()
                rows = self.auth[code]
                et.apply_round(rows, [(ln, self._req(k, hits))
                                      for ln, k, hits in lanes], now,
                               self.fdt)
                ans = et.apply_round(rows, [(ln, self._req(k, 0))
                                            for ln, k, _ in lanes], now,
                                     self.fdt)
                o = code // self.geo.nb_auth
                for (ln, k, _), a in zip(lanes, ans):
                    if self.in_k1[k]:
                        bcast.setdefault(int(self.rb[k]), []).append(
                            ((o, ln), (int(self.h[k]), int(self.algo[k]),
                                       a[1], a[2], a[0], a[3])))
            for b, items in bcast.items():
                items.sort()
                for c in self.cards_of[b]:
                    store_cached(self.rep[(c, b)], [x for _, x in items],
                                 now)

    def call(self, ids: np.ndarray, now: int):
        """One call of checks `ids` at `now`: the sync of the previous
        call's queue, then the serves: key j of a peer in lane order takes
        lane j mod batch_size of round j div batch_size, and the rounds
        run in order.  Returns the positions in `ids` of the checks on
        sampled keys and their answers (int64[m, 4])."""
        self._sync(now)
        ids = np.asarray(ids, np.int64)
        pos = np.flatnonzero(self.is_serve[ids])
        answers = np.zeros((pos.size, 4), np.int64)
        if not (pos.size or self.in_k2[ids].any()):
            self.queued = []
            return pos, answers
        uniq, hits = self._distinct(ids)
        if pos.size:
            arr = self.arr[uniq]
            rnd = self._rank(arr) // self.geo.batch_size
            lanes: Dict[tuple, list] = {}
            for j in np.flatnonzero(self.is_serve[uniq]).tolist():
                k = int(uniq[j])
                lanes.setdefault((int(rnd[j]), int(arr[j]), int(self.rb[k])),
                                 []).append(j)
            got = np.zeros((uniq.size, 4), np.int64)
            for (_, c, b), js in sorted(lanes.items()):
                out = serve_round(self.rep[(c, b)], [
                    self._req(int(uniq[j]), int(hits[j])) for j in js],
                    now, self.fdt)
                got[js] = out
            at = np.searchsorted(uniq, ids[pos], sorter=np.argsort(uniq))
            answers = got[np.argsort(uniq)[at]]
        self._queue(uniq, hits)
        return pos, answers

    def rep_rows(self) -> Dict[str, np.ndarray]:
        """The sampled replica buckets' rows, [pairs, ways] a field, in
        `pairs` order."""
        return _rows([self.rep[p] for p in self.pairs])

    def auth_rows(self) -> Dict[str, np.ndarray]:
        """The closure's authoritative buckets' rows, in `auth_codes` order
        (owner * nb_auth + bucket)."""
        return _rows([self.auth[int(a)] for a in self.auth_codes])


def _rows(buckets: List[List[list]]) -> Dict[str, np.ndarray]:
    out = {}
    for j, f in enumerate(et.ROW_FIELDS):
        dt = np.float64 if f == "remaining_f" else np.int64
        out[f] = np.array([[row[j] for row in rows] for rows in buckets],
                          dtype=dt).reshape(len(buckets), -1)
    return out
