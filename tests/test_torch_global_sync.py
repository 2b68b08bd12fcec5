"""The port's collective GLOBAL engine (gubernator_tpu_torch/parallel/
global_sync.py) on the CPU against the JAX package's GlobalEngine on
conftest's virtual CPU devices.

Both collectives (psum, the default, and a2a) on the same interleavings of
checks and syncs: every answer equal, and the auth table and the replicated
cache table equal word for word after every sync.  Then the corners: a chunk
overflow (more than D keys for one owner), the batch-limit trigger, a cache
smaller than the auth table, a hot key aggregated to one lane, fingerprints
with the top bit set, and the auth rows against a single-table TorchBackend
that applied the same per-sync aggregates (tests/test_differential.py's
pattern)."""
from __future__ import annotations

import random
from dataclasses import replace as dc_replace

import numpy as np
import pytest
import torch

from gubernator_tpu.core.config import DeviceConfig as JaxDeviceConfig
from gubernator_tpu.core.hashing import key_hash64
from gubernator_tpu.core.types import RateLimitReq
from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.parallel.global_sync import (
    GlobalEngine,
    merge_a2a,
    merge_psum,
    zero_delta_grid,
)
from gubernator_tpu_torch.parallel.mesh import shard_of_hash
from gubernator_tpu_torch.parallel.sharded import MeshBackend
from gubernator_tpu_torch.runtime.backend import TorchBackend

SLOTS, WAYS, B, N = 1024, 8, 32, 4
GLOBAL = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def engines(clock, collective="psum", n=N, cache_slots=None, **kw):
    """(port engine, JAX engine) over mesh backends of one geometry."""
    from gubernator_tpu.parallel.global_sync import GlobalEngine as JaxEngine
    from gubernator_tpu.parallel.sharded import MeshBackend as JaxMesh

    geo = dict(num_slots=SLOTS, ways=WAYS, batch_size=B, num_shards=n,
               global_cache_slots=cache_slots)
    pe = GlobalEngine(MeshBackend(DeviceConfig(platform="cpu", **geo),
                                  clock=clock), collective=collective, **kw)
    je = JaxEngine(JaxMesh(JaxDeviceConfig(**geo), clock=clock),
                   collective=collective, **kw)
    return pe, je


def resp_key(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


def assert_same_state(pe, je, ctx=""):
    """Auth table and cache table equal word for word."""
    for tp, tj in ((pe.b.table, je.b.table),
                   (pe.cache_table, je.cache_table)):
        for f in tj._fields:
            np.testing.assert_array_equal(
                getattr(tp, f).numpy(), np.asarray(getattr(tj, f)),
                err_msg=f"{ctx} {f}")


def greq(rng, n_keys, prefix="k"):
    k = rng.randrange(n_keys)
    return RateLimitReq(
        name="g", unique_key=f"{prefix}{k}", hits=rng.choice([0, 1, 1, 2, 3]),
        limit=20 + 5 * (k % 3), duration=60_000, algorithm=k % 2,
        behavior=GLOBAL)


def drive(pe, je, clock, rng, steps, n_keys=40, per_call=20, prefix="k",
          sync_p=0.4):
    """Random interleavings of check() and sync() through both engines,
    comparing every answer, and both tables after every sync."""
    for step in range(steps):
        batch = [greq(rng, n_keys, prefix)
                 for _ in range(rng.randrange(1, per_call))]
        got, want = pe.check(batch), je.check(batch)
        assert [resp_key(r) for r in got] == \
            [resp_key(r) for r in want], step
        if rng.random() < sync_p:
            assert pe.sync() == je.sync()
            assert_same_state(pe, je, f"step {step}")
        clock.advance(rng.choice([0, 40, 900]))
    assert pe.sync() == je.sync()
    assert_same_state(pe, je, "final")
    assert (pe.syncs, pe.sync_keys) == (je.syncs, je.sync_keys)


@pytest.mark.parametrize("collective", ["psum", "a2a"])
def test_engine_interleavings_match_jax(collective, frozen_clock):
    pe, je = engines(frozen_clock, collective, delta_slots=16)
    pe.warmup()
    je.warmup()
    drive(pe, je, frozen_clock, random.Random(len(collective)), 20)
    assert pe.cache_occupancy() == je.cache_occupancy() > 0


@pytest.mark.parametrize("collective", ["psum", "a2a"])
def test_chunk_overflow_more_keys_than_delta_slots(collective,
                                                   frozen_clock):
    """40 keys for ONE owner with D = 4 lanes a chunk: ten chunks, each
    synced in order, as the JAX engine syncs them."""
    pe, je = engines(frozen_clock, collective, delta_slots=4,
                     batch_limit=10_000)
    keys, i = [], 0
    while len(keys) < 40:
        r = RateLimitReq(name="g", unique_key=f"o{i}", hits=1 + i % 3,
                         limit=9, duration=60_000, algorithm=i % 2,
                         behavior=GLOBAL)
        if int(shard_of_hash(key_hash64(r.hash_key()), N)) == 1:
            keys.append(r)
        i += 1
    got, want = pe.check(keys), je.check(keys)
    assert [resp_key(r) for r in got] == [resp_key(r) for r in want]
    assert len(pe._build_chunks(pe.pending, frozen_clock.now())) == 10
    assert pe.sync() == je.sync() == 40
    assert_same_state(pe, je)


def test_batch_limit_triggers_sync(frozen_clock):
    """check() syncs on its own once `batch_limit` keys are pending."""
    pe, je = engines(frozen_clock, batch_limit=7)
    rng = random.Random(9)
    for step in range(12):
        batch = [greq(rng, 30) for _ in range(5)]
        got, want = pe.check(batch), je.check(batch)
        assert [resp_key(r) for r in got] == [resp_key(r) for r in want]
        assert pe.syncs == je.syncs and len(pe.pending) == len(je.pending)
        assert len(pe.pending) < 7
    assert pe.syncs >= 3
    assert_same_state(pe, je)


def test_smaller_global_cache(frozen_clock):
    """global_cache_slots = num_slots / 4: the cache's own geometry for
    ingest, probe, upsert and point reads."""
    pe, je = engines(frozen_clock, cache_slots=SLOTS // 4, delta_slots=16)
    assert pe.cache_table.key.shape[0] == SLOTS // 4 == pe.cache_slots
    drive(pe, je, frozen_clock, random.Random(5), 15, n_keys=60)
    for k in range(0, 60, 7):
        key = f"g_k{k}"
        got, want = pe.get_cached(key), je.get_cached(key)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.remaining, got.expire_at, int(got.status)) == \
                (want.remaining, want.expire_at, int(want.status))


def test_hot_key_aggregates_to_one_lane(frozen_clock):
    """40 hits on one key in one call: one lane, one pending entry with
    the summed hits, every duplicate answered alike; after the sync the
    broadcast row carries the owner's 10 remaining."""
    pe, je = engines(frozen_clock)
    hot = [RateLimitReq(name="g", unique_key="hot", hits=1, limit=50,
                        duration=60_000, behavior=GLOBAL)] * 40
    got, want = pe.check(hot), je.check(hot)
    assert [resp_key(r) for r in got] == [resp_key(r) for r in want]
    assert len({resp_key(r) for r in got}) == 1
    assert list(pe.pending) == ["g_hot"] and pe.pending["g_hot"].hits == 40
    assert pe.sync() == je.sync() == 1
    assert_same_state(pe, je)
    got, want = pe.check(hot[:1]), je.check(hot[:1])
    assert resp_key(got[0]) == resp_key(want[0])
    assert int(got[0].status) == 0 and got[0].remaining == 10


def test_top_bit_fingerprints(frozen_clock):
    """Keys whose fingerprints have the top bit set (negative as int64)
    merge through both collectives exactly, and through the engines as
    the JAX engines merge them."""
    names = []
    i = 0
    while len(names) < 24:
        if key_hash64(f"g_t{i}") >> 63:
            names.append(f"t{i}")
        i += 1
    n, D = N, 8
    grid = zero_delta_grid(n, D)
    for j, name in enumerate(names[:n * D // 2]):
        h = key_hash64(f"g_{name}")
        dst = int(shard_of_hash(h, n))
        lane = int((grid.key_hash[:, dst] != 0).sum())
        grid.key_hash[j % n, dst, lane] = np.uint64(h).view(np.int64)
        grid.hits[j % n, dst, lane] = j + 1
        grid.limit[j % n, dst, lane] = 100
    dev = [torch.from_numpy(np.ascontiguousarray(a)) for a in grid]
    q = merge_psum(type(grid)(*dev))
    assert int((q[0] < 0).sum()) == n * D // 2
    assert q[1].sum() == sum(range(1, n * D // 2 + 1))
    qa = merge_a2a(type(grid)(*dev))
    for s in range(n):  # the same lanes, in sorted order
        assert sorted(qa[0, s][qa[10, s] != 0].tolist()) == \
            sorted(q[0, s][q[10, s] != 0].tolist())
    for collective in ("psum", "a2a"):
        pe, je = engines(frozen_clock, collective, delta_slots=4)
        reqs = [RateLimitReq(name="g", unique_key=t, hits=2, limit=5,
                             duration=60_000, behavior=GLOBAL)
                for t in names]
        pe.check(reqs)
        je.check(reqs)
        assert pe.sync() == je.sync() == len(names)
        assert_same_state(pe, je, collective)


def test_auth_rows_match_single_table_aggregates(frozen_clock):
    """After each sync, hits=0 probes of the auth rows equal a
    single-table TorchBackend that applied the same per-sync aggregates
    (last request's params, summed hits) at the same frozen time."""
    pe = GlobalEngine(MeshBackend(DeviceConfig(
        num_slots=SLOTS, ways=WAYS, batch_size=B, num_shards=N,
        platform="cpu"), clock=frozen_clock))
    ref = TorchBackend(DeviceConfig(num_slots=SLOTS, ways=WAYS,
                                    batch_size=B, platform="cpu"),
                       clock=frozen_clock)
    rng = random.Random(7)
    pend, seen = {}, {}
    for step in range(30):
        for _ in range(rng.randrange(1, 20)):
            req = dc_replace(greq(rng, 12), behavior=0)
            key = req.hash_key()
            cur = pend.get(key)
            pend[key] = (req, (cur[1] if cur else 0) + req.hits)
            seen[key] = req
            pe.check([req])
        if rng.random() < 0.5 and pend:
            assert pe.sync() == len(pend)
            ref.check([dc_replace(r, hits=h) for r, h in pend.values()])
            pend.clear()
            probes = [dc_replace(r, hits=0) for r in seen.values()]
            assert [resp_key(r) for r in pe.b.check(probes)] == \
                [resp_key(r) for r in ref.check(probes)], step
        frozen_clock.advance(rng.choice([0, 100, 2_000]))
