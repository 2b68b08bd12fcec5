"""Entry module of the exact tier: `TorchBackend.step_rounds_begin` and the
fetch closure it returns, called as the fast lane's exact merge calls them
(runtime/fastpath.py): one `batch_size`-wide `DeviceBatch` round a call,
its active lanes filled from lane 0, padding lanes all zero, and the
engine built as the daemon builds it (runtime/service.py), with its
metrics object.

Set-up makes the keys from the seed and populates the table with one full
pass of them through the same entry (which also loads K1 and sizes its
scratch at the cell's tier).  The program's `warmup()` is not called: it
writes a synthetic row into the table and warms state-plane ops that no
call of the window uses.

The clock is virtual: call g runs at t0 + g * ms_per_call, whatever the
wall clock says, so every answer depends on the seed and the call's index
alone.  The check follows a sample of buckets drawn from the seed: every
answer of a lane whose key lies in one, populate and window alike, and
their rows once the window has closed, against the plain reference
(reference/exact_table.py).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from benchmark.generator import generate, over_by_tenth
from benchmark.reference import exact_table
from benchmark.yardstick import useful_bytes

ANSWER_FIELDS = ("status", "limit", "remaining", "reset_time")


class _Calls:
    """The calls of a pass of `lanes`-wide rounds: their DeviceBatch and
    the lanes of sampled keys.  Full-width calls are views of the per-key
    columns; narrower ones are written into a ring of zeroed rounds."""

    def __init__(self, t, lanes: int, B: int, samp: np.ndarray,
                 ring: int) -> None:
        from gubernator_tpu_torch.ops.batch import DeviceBatch, empty_batch

        self.t, self.lanes, self.B = t, lanes, B
        self.per_pass = t.calls_per_pass(lanes)
        cut = np.searchsorted(samp, np.arange(self.per_pass + 1) * lanes)
        self.samples = [samp[cut[c]:cut[c + 1]] - c * lanes
                        for c in range(self.per_pass)]
        self.views: Optional[list] = None
        if lanes == B:
            ones = np.ones(B, dtype=bool)
            zb, z64 = np.zeros(B, dtype=bool), np.zeros(B, dtype=np.int64)
            hits = np.full(B, t.hits, dtype=np.int64)
            self.views = []
            for c in range(self.per_pass):
                s, e = t.call_span(c, lanes)
                if e - s == B:
                    self.views.append(DeviceBatch(
                        key_hash=t.key_hash[s:e], hits=hits,
                        limit=t.limit[s:e], duration=t.duration[s:e],
                        algo=t.algo[s:e], burst=t.limit[s:e],
                        reset_remaining=t.reset[s:e], is_greg=zb,
                        greg_expire=z64, greg_duration=z64, active=ones,
                        use_cached=zb))
                else:
                    db = empty_batch(B)
                    self._fill(db, s, e, 0)
                    self.views.append(db)
        else:
            self.ring = [empty_batch(B) for _ in range(ring)]
            self.ring_n = [0] * ring
            self.next = 0

    def _fill(self, db, s: int, e: int, was: int) -> None:
        """Write keys [s, e) into lanes 0.. of `db`, zeroing lanes up to
        `was` (the previous fill's count)."""
        t, n = self.t, e - s
        cols = dict(key_hash=t.key_hash, limit=t.limit,
                    duration=t.duration, algo=t.algo, burst=t.limit,
                    reset_remaining=t.reset)
        for f, a in cols.items():
            getattr(db, f)[:n] = a[s:e]
        db.hits[:n] = t.hits
        db.active[:n] = True
        if was > n:
            for f in db._fields:
                getattr(db, f)[n:was] = 0

    def batch(self, c: int):
        """(round, active lanes) of call c of the pass."""
        s, e = self.t.call_span(c, self.lanes)
        if self.views is not None:
            return self.views[c], e - s
        k = self.next
        self.next = (k + 1) % len(self.ring)
        self._fill(self.ring[k], s, e, self.ring_n[k])
        self.ring_n[k] = e - s
        return self.ring[k], e - s


class Entry:
    kind = "exact"

    def __init__(self, config: dict, mix: dict, seed: int, device: str,
                 log) -> None:
        self.config, self.mix, self.seed = config, mix, seed
        self.device, self.log = device, log
        self.traced = False
        self.traced_bytes = 0
        self.window_calls = 0
        self._rec: List[tuple] = []
        self._rows: Optional[Dict[str, np.ndarray]] = None

    # -- set-up ----------------------------------------------------------
    def make_traffic(self) -> None:
        t = self.t = generate(self.mix, self.config, self.seed,
                              self.device)
        self.in_flight = t.in_flight
        self.samp = t.sample_positions(self.seed)
        self.samp_buckets = np.unique(t.bucket_of(t.key_hash[self.samp]))
        self.populate_calls = t.calls_per_pass(t.populate_lanes)

    def setup(self) -> None:
        from gubernator_tpu_torch.core.clock import Clock
        from gubernator_tpu_torch.core.config import DeviceConfig
        from gubernator_tpu_torch.runtime.backend import TorchBackend
        from gubernator_tpu_torch.runtime.metrics import Metrics

        t0 = time.perf_counter()
        self.make_traffic()
        t1 = time.perf_counter()
        t, d = self.t, self.config["device"]
        tiers = d.get("batch_tiers")
        self.cfg = DeviceConfig(
            num_slots=int(d["num_slots"]), ways=int(d["ways"]),
            batch_size=int(d["batch_size"]),
            batch_tiers=tuple(tiers) if tiers else None,
            platform=self.device)
        self.clock = Clock()
        self.clock.freeze(t.t0_ms * 10**6)
        self.be = TorchBackend(self.cfg, clock=self.clock, metrics=Metrics())
        B = self.cfg.batch_size
        ring = self.in_flight + 2
        pop = _Calls(t, t.populate_lanes, B, self.samp, ring)
        self.win = (pop if t.lanes == t.populate_lanes
                    else _Calls(t, t.lanes, B, self.samp, ring))
        pending = []
        for g in range(self.populate_calls):
            pending.append(self._begin(g, pop, g))
            if len(pending) == self.in_flight:
                self._end(pending.pop(0))
        while pending:
            self._end(pending.pop(0))
        self.log(f"set-up: traffic {t1 - t0:.3f} s, engine and populate "
                 f"({self.populate_calls} calls) "
                 f"{time.perf_counter() - t1:.3f} s")

    # -- calls -----------------------------------------------------------
    def _begin(self, g: int, calls: _Calls, c: int):
        self.clock.freeze((self.t.t0_ms + g * self.t.ms_per_call) * 10**6)
        db, n = calls.batch(c)
        return g, calls.samples[c], n, self.be.step_rounds_begin([db])

    def _end(self, token) -> int:
        g, idx, n, fetch = token
        h = fetch()[0]
        if idx.size:
            self._rec.append((g, idx, np.stack(
                [h[f][idx] for f in ANSWER_FIELDS], axis=1)))
        if self.traced:
            self.traced_bytes += useful_bytes(
                1, n, int(np.count_nonzero(h["found"])),
                int(np.count_nonzero((h["persisted"] != 0)
                                     & (h["cached"] == 0))),
                self.cfg.ways)
        return n

    def dispatch(self, i: int):
        """Start window call i."""
        self.window_calls = max(self.window_calls, i + 1)
        return self._begin(self.populate_calls + i, self.win,
                           i % self.win.per_pass)

    def fetch(self, token) -> int:
        """Finish a call; returns the decisions it returned."""
        return self._end(token)

    # -- the check -------------------------------------------------------
    def read_state(self) -> None:
        """Copy the sampled buckets' rows to the host."""
        import torch

        ways = self.cfg.ways
        slots = (self.samp_buckets[:, None] * ways
                 + np.arange(ways)).reshape(-1)
        idx = torch.from_numpy(slots).to(self.be.device)
        self._rows = {f: getattr(self.be.table, f)[idx].cpu().numpy()
                      for f in exact_table.ROW_FIELDS}

    def free(self) -> None:
        import torch

        self.be = None
        self.win = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _events(self, window_calls: int):
        """The sampled lanes of every call as reference events, sorted by
        call, bucket, lane, and their request columns."""
        t, p = self.t, self.samp
        g, lane, pos = [p // t.populate_lanes], [p % t.populate_lanes], [p]
        per = t.calls_per_pass(t.lanes)
        for q in range(-(-window_calls // per)):
            w = q * per + p // t.lanes
            keep = w < window_calls
            g.append(self.populate_calls + w[keep])
            lane.append((p % t.lanes)[keep])
            pos.append(p[keep])
        g, lane, pos = (np.concatenate(a) for a in (g, lane, pos))
        bucket = t.bucket_of(t.key_hash[pos])
        order = np.lexsort((lane, bucket, g))
        g, lane, pos, bucket = g[order], lane[order], pos[order], \
            bucket[order]
        now = t.t0_ms + g * t.ms_per_call
        events = np.stack([g, now, bucket, lane], axis=1)
        reqs = dict(key_hash=t.key_hash[pos],
                    hits=np.full(pos.size, t.hits, dtype=np.int64),
                    limit=t.limit[pos], duration=t.duration[pos],
                    algo=t.algo[pos].astype(np.int64),
                    burst=t.limit[pos], reset=t.reset[pos].astype(np.int64))
        return events, reqs

    def _reference(self, window_calls: int, fdt):
        events, reqs = self._events(window_calls)
        ways = self.t.ways
        answers, table = exact_table.replay(events, reqs, ways, fdt)
        order = np.lexsort((events[:, 3], events[:, 0]))
        keys = events[order][:, [0, 3]]
        rows = {f: np.zeros((self.samp_buckets.size, ways),
                            dtype=np.float64 if f == "remaining_f"
                            else np.int64)
                for f in exact_table.ROW_FIELDS}
        for i, b in enumerate(self.samp_buckets.tolist()):
            for w, row in enumerate(table.get(b, [])):
                for j, f in enumerate(exact_table.ROW_FIELDS):
                    rows[f][i, w] = row[j]
        return keys, answers[order], rows

    def _program_answers(self):
        if not self._rec:
            return np.zeros((0, 2), np.int64), np.zeros((0, 4), np.int64)
        keys = np.concatenate([
            np.stack([np.full(idx.size, g), idx], axis=1)
            for g, idx, _ in self._rec])
        answers = np.concatenate([a for _, _, a in self._rec])
        order = np.lexsort((keys[:, 1], keys[:, 0]))
        return keys[order], answers[order]

    @staticmethod
    def _compare(keys_a, ans_a, keys_b, ans_b, rows_a, rows_b):
        if keys_a.shape != keys_b.shape or not np.array_equal(keys_a,
                                                              keys_b):
            wrong = max(len(keys_a), len(keys_b))
        else:
            wrong = int(np.count_nonzero((ans_a != ans_b).any(axis=1)))
        bad = np.zeros(rows_b["key"].shape, dtype=bool)
        for f in exact_table.ROW_FIELDS:
            bad |= rows_a[f] != rows_b[f]
        return wrong, int(np.count_nonzero(bad))

    def verify(self) -> Dict[str, tuple]:
        """The compared numbers, each with its limit: answers and rows of
        the sampled buckets that differ from the reference's."""
        keys_r, ans_r, rows_r = self._reference(self.window_calls,
                                                np.float64)
        keys_p, ans_p = self._program_answers()
        rows_p = {f: self._rows[f].reshape(rows_r[f].shape)
                  for f in exact_table.ROW_FIELDS}
        wrong, rows_wrong = self._compare(keys_p, ans_p, keys_r, ans_r,
                                          rows_p, rows_r)
        self.log(f"check: {len(keys_r)} sampled answers in "
                 f"{self.samp_buckets.size} buckets over "
                 f"{self.populate_calls} populate and {self.window_calls} "
                 f"window calls; {rows_r['key'].size} rows; % over limit "
                 f"in each tenth of the window: " + over_by_tenth(
                     keys_r[:, 0] - self.populate_calls, ans_r[:, 0],
                     self.window_calls))
        return {"answers_wrong": (wrong, 0), "rows_wrong": (rows_wrong, 0)}


class Control(Entry):
    """The check's control: the run as the cell makes it, with the
    program's sampled answers and rows put aside once the window has
    closed and the plain reference's, computed with the leaky bucket's
    arithmetic in float32 (the configuration states float64), put in
    their place; `verify()` judges them as it judges the program's."""

    def read_state(self) -> None:
        super().read_state()
        keys, answers, rows = self._reference(self.window_calls, np.float32)
        self._answers = keys, answers
        self._rows = {f: v.reshape(-1) for f, v in rows.items()}

    def _program_answers(self):
        return self._answers
