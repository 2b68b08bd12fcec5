"""The port's collective GLOBAL engine (gubernator_tpu_torch/parallel/
global_sync.py) on a 4-shard CPU mesh against the benchmark's plain reference
of GLOBAL's replicated answers (benchmark/reference/global_cluster.py), which
imports nothing of either package.

A call is what the benchmark's GLOBAL cell makes it: the sync of the queue at
the call's clock, then `GlobalEngine.check` of 1000 Zipfian checks, given in
ascending fingerprint order (the fast lane's order).  Tiny tables (2^10 slots
a shard, a few thousand keys) overfill buckets in both kinds of table, an
owner's keys overflow `delta_slots` so a sync takes several chunks, and every
(card, replica bucket) pair is followed: every answer and every row
bit-exact, on 3 seeds.  Then a hot key met many times in one call, the
control in float32, and the engine's stages under a recording profiler.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.global_traffic import ZipfPool
from benchmark.reference import exact_table
from benchmark.reference import global_cluster as gc
from gubernator_tpu_torch.core.clock import Clock
from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.core.hashing import bulk_key_hash64
from gubernator_tpu_torch.core.types import Behavior, RateLimitReq
from gubernator_tpu_torch.parallel.global_sync import GlobalEngine
from gubernator_tpu_torch.parallel.sharded import MeshBackend
from gubernator_tpu_torch.runtime import tracing

N, WAYS, SLOTS, D, B = 4, 8, 4 * 1024, 64, 256
CONFIG = {"keys": 3000, "num_shards": N,
          "deployment": {"delta_slots": D},
          "device": {"num_slots": SLOTS, "global_cache_slots": SLOTS,
                     "ways": WAYS, "batch_size": B}}
MIX = {"limit_name": "g", "zipf_theta": 0.99, "lanes_per_call": 1000,
       "populate_lanes_per_call": 1000, "pool_calls": 6, "in_flight": 1,
       "algo_mix": {"token": 1, "leaky": 1}, "hits": 1, "limits": [1, 30],
       "duration_ms": {"low": 1000, "high": 20000, "step": 1000},
       "clock": {"t0_ms": 1_760_000_000_000, "ms_per_call": 700},
       "check": {"pairs": 0, "overfull_share": 0, "hot_keys": 0}}
SEEDS = [2**31 + 11, 2**33 + 5, 7]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Run:
    """The traffic, the engine on a CPU mesh and the reference, stepped
    together call by call."""

    def __init__(self, seed, fdt=np.float64):
        self.t = ZipfPool(MIX, CONFIG, seed)
        self.h = bulk_key_hash64(self.t.hash_keys())
        self.geo = gc.geometry(CONFIG)
        self.pairs = [(c, b) for c in range(N)
                      for b in range(self.geo.nb_rep)]
        self.ref = gc.Cluster(self.h, self.t.limit, self.t.duration,
                              self.t.algo, self.pairs, self.geo, fdt)
        self.clock = Clock()
        self.be = MeshBackend(
            DeviceConfig(num_slots=SLOTS, ways=WAYS, batch_size=B,
                         num_shards=N, global_cache_slots=SLOTS,
                         platform="cpu"), clock=self.clock)
        self.eng = GlobalEngine(self.be, delta_slots=D, batch_limit=10**9)

    def reqs(self, ids):
        t = self.t
        return [RateLimitReq(name=t.name, unique_key=t.prefix + str(k),
                             hits=t.hits, limit=int(t.limit[k]),
                             duration=int(t.duration[k]),
                             algorithm=int(t.algo[k]),
                             behavior=int(Behavior.GLOBAL),
                             burst=int(t.limit[k])) for k in ids]

    def call(self, g, ids=None):
        """Call g on both: (program answers, reference answers), int64[m,
        4] in the call's check order."""
        ids = self.t.call_ids(g) if ids is None else np.asarray(ids)
        now = self.t.now_ms(g)
        self.clock.freeze(now * 10**6)
        self.eng.sync()
        order = np.argsort(self.h[ids], kind="stable")
        out = self.eng.check(self.reqs(ids[order]))
        got = np.zeros((ids.size, 4), np.int64)
        got[order] = [(int(r.status), r.limit, r.remaining, r.reset_time)
                      for r in out]
        pos, want = self.ref.call(ids, now)
        assert np.array_equal(pos, np.arange(ids.size))
        return got, want

    def rows(self):
        """(program, reference) rows of every replica bucket and of the
        reference's authoritative buckets, field by field."""
        cache, auth = self.eng.cache_table, self.be.table
        local = SLOTS // N
        rep = np.array([c * local + b * WAYS for c, b in self.pairs])
        codes = self.ref.auth_codes
        ab = ((codes // self.geo.nb_auth) * local
              + (codes % self.geo.nb_auth) * WAYS)
        mine = {}
        for part, tab, base in (("replica", cache, rep), ("auth", auth, ab)):
            idx = (base[:, None] + np.arange(WAYS)).reshape(-1)
            mine[part] = {f: getattr(tab, f).numpy()[idx].reshape(-1, WAYS)
                          for f in exact_table.ROW_FIELDS}
        return mine, {"replica": self.ref.rep_rows(),
                      "auth": self.ref.auth_rows()}


def assert_rows_equal(mine, want):
    for part in ("replica", "auth"):
        for f in exact_table.ROW_FIELDS:
            np.testing.assert_array_equal(mine[part][f], want[part][f],
                                          err_msg=f"{part} {f}")


@pytest.mark.parametrize("seed", SEEDS)
def test_engine_matches_the_plain_reference(seed):
    run = Run(seed)
    t = run.t
    calls = t.populate_calls + 2 * t.pool_calls
    for g in range(calls):
        got, want = run.call(g)
        np.testing.assert_array_equal(got, want, err_msg=f"call {g}")
    assert_rows_equal(*run.rows())
    # What the run went through: duplicates inside a call, both kinds of
    # bucket, buckets holding more keys than ways in both tables, an owner
    # overflowing delta_slots, cached answers and local ones.
    ids = t.call_ids(t.populate_calls)
    assert np.unique(ids).size < ids.size / 2
    assert set(np.unique(t.algo)) == {0, 1}
    geo = run.geo
    assert np.bincount(gc.rep_bucket(run.h, geo)).max() > WAYS
    code = gc.owner(run.h, N).astype(np.int64) * geo.nb_auth \
        + gc.auth_bucket(run.h, geo)
    assert np.bincount(code).max() > WAYS
    uniq = np.unique(ids)
    assert np.bincount(gc.owner(run.h[uniq], N).astype(np.int64)).max() > D
    mine, _ = run.rows()
    kinds = mine["replica"]["kind"][mine["replica"]["key"] != 0]
    assert {0, gc.KIND_CACHED} <= set(kinds.tolist())


def test_a_hot_key_met_many_times_in_a_call_is_one_lane():
    run = Run(SEEDS[0])
    for g in range(run.t.populate_calls):
        run.call(g)
    k = int(run.t.key_of_rank[0])
    g = run.t.populate_calls
    ids = np.array([k] * 60 + list(run.t.call_ids(g)[:40]))
    got, want = run.call(g, ids)
    np.testing.assert_array_equal(got, want)
    assert (got[:60] == got[0]).all()
    # The next sync gives the owner all 60 hits at once.
    got, want = run.call(g + 1, ids[60:])
    np.testing.assert_array_equal(got, want)
    assert_rows_equal(*run.rows())


def test_the_control_in_float32_differs():
    run = Run(SEEDS[1])
    low = gc.Cluster(run.h, run.t.limit, run.t.duration, run.t.algo,
                     run.pairs, run.geo, np.float32)
    differs = False
    for g in range(run.t.populate_calls + run.t.pool_calls):
        got, _ = run.call(g)
        _, want = low.call(run.t.call_ids(g), run.t.now_ms(g))
        differs |= not np.array_equal(got, want)
    low_rows = {"replica": low.rep_rows(), "auth": low.auth_rows()}
    mine, _ = run.rows()
    differs |= any(not np.array_equal(mine[p][f], low_rows[p][f])
                   for p in mine for f in exact_table.ROW_FIELDS)
    assert differs


def test_stages_log_only_while_a_profiler_records():
    run = Run(SEEDS[2])
    t = run.t
    for g in range(t.populate_calls):
        run.call(g)
    before = tracing.stage_records()
    run.call(t.populate_calls)  # not recording: nothing logged
    assert tracing.stage_records() == before
    g = t.populate_calls + 1
    ids = t.call_ids(g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run.clock.freeze(t.now_ms(g) * 10**6)
        run.eng.sync()
        order = np.argsort(run.h[ids], kind="stable")
        reqs = run.reqs(ids[order])
        uniq = len({r.hash_key() for r in reqs})
        run.eng.check(reqs)
    recs = [r for r in tracing.stage_records() if r[0].startswith("global.")]
    names = [r[0] for r in recs]
    sync = ["global.collect", "global.apply", "global.broadcast"]
    chunks = [r[4]["chunks"] for r in recs if r[0] == "global.build"][0]
    assert names == (["global.build", "global.stage"] + sync * chunks
                     + ["global.serve", "global.fetch"])
    assert chunks >= 2 and len({r[1] for r in recs}) == 1
    assert recs[0][4]["keys"] == np.unique(t.call_ids(g - 1)).size
    serve = recs[-2][4]
    assert serve["active"] == uniq and serve["lanes"] % N == 0
    assert serve["lanes"] >= uniq
    assert not {e.name for e in prof.events()} & set(names)
    # serve_packed, the fast lane's entry, logs its serve with its lanes;
    # a stage outside a recording ends the log's recording.
    tracing.stage_begin()
    with profile(activities=[ProfilerActivity.CPU]):
        packed = run.eng.serve_packed([], [])
        run.eng.fetch_packed(packed[0])
    recs = tracing.stage_records()
    assert [r[0] for r in recs] == ["global.serve", "global.fetch"]
    assert recs[0][4] == {"lanes": 0, "active": 0}
