"""The state plane on the port's sharded table (MeshBackend at 4 shards, its
GlobalEngine, the fast lane's grid rounds) against the JAX package's mesh,
on the CPU.

Checkpoints save and restore in each package and cross between them (both
meshes keep the JAX `table_to_host` layout, shard-major); a Loader round
trip; Store seeding and write-through; the engine's Store seeding and its
sync-time write-through; the generic migrate_extract_rows /
migrate_inject_rows paths the reshard plane and the cold tier run on a mesh;
and the fast lane's cold-key repair over shard-grid rounds.  The scenarios
are tests/test_torch_store.py's, run on a mesh geometry."""
from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch
from test_torch_store import (
    Pkg,
    checkpoint_scenario,
    item_tuple,
    lane_payloads,
    resp_tuple,
)

from gubernator_tpu.core import config as jcfg
from gubernator_tpu_torch.core import config as pcfg

SHARDS, SLOTS, WAYS, B = 4, 4096, 8, 128
GLOBAL = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class MeshPkg(Pkg):
    """Pkg on a 4-shard mesh: the service builds the mesh backend and
    its GlobalEngine, `backend()` a MeshBackend."""

    def device(self, slots=SLOTS, batch=B):
        geo = dict(num_slots=slots, ways=WAYS, batch_size=batch,
                   num_shards=SHARDS)
        if self.port:
            return pcfg.DeviceConfig(platform="cpu", **geo)
        return jcfg.DeviceConfig(**geo)

    def backend(self, clock, slots=SLOTS, **kw):
        if self.port:
            from gubernator_tpu_torch.parallel.sharded import MeshBackend
        else:
            from gubernator_tpu.parallel.sharded import MeshBackend
        return MeshBackend(self.device(slots), clock=clock, **kw)

    def engine(self, backend, **kw):
        if self.port:
            from gubernator_tpu_torch.parallel.global_sync import GlobalEngine
        else:
            from gubernator_tpu.parallel.global_sync import GlobalEngine
        return GlobalEngine(backend, **kw)


PORT, JAX = MeshPkg(True), MeshPkg(False)


def in_turn_mesh(clock, scenario):
    """scenario(pkg) on the port's mesh, then on JAX's from the same
    instant."""
    t0 = clock.now_ns()
    got = scenario(PORT)
    clock.freeze(t0)
    return got, scenario(JAX)


def test_mesh_checkpoints_restore_in_and_across_packages(frozen_clock,
                                                         tmp_path):
    """Each package's checkpointer round-trips its mesh; the restored
    tables are equal word for word, and a table saved by either
    package's mesh restores into the other's and serves alike."""
    got, want = in_turn_mesh(frozen_clock, lambda P: checkpoint_scenario(
        P, frozen_clock, str(tmp_path / ("port" if P.port else "jax"))))
    for f in want[0]:
        np.testing.assert_array_equal(got[0][f], want[0][f], err_msg=f)
    # A batch inserts at most 3 new keys a bucket (INSERT_ROUNDS) in both.
    assert got[1] == want[1] and len(got[1]) > 290
    assert got[3] == want[3]
    # Across: the port's table into a JAX mesh and the JAX table into a
    # port mesh, then the same checks through all four.
    reqs = [PORT.req(name="ck", unique_key=f"k{i}", hits=2, limit=10,
                     duration=3_600_000, algorithm=i % 2)
            for i in range(0, 300, 3)]
    pb, jb = PORT.backend(frozen_clock), JAX.backend(frozen_clock)
    jb._install_table(got[0])
    pb._install_table({f: np.asarray(a) for f, a in want[0].items()})
    answers = [[resp_tuple(r) for r in b.check(reqs)] for b in (pb, jb)]
    assert answers[0] == answers[1]
    for f, a in jb.snapshot().items():
        np.testing.assert_array_equal(pb.snapshot()[f], np.asarray(a))


def test_mesh_loader_round_trip(frozen_clock):
    """Load at startup, save at shutdown (GLOBAL broadcast rows never
    saved), and a restart continues the saved buckets."""
    def scenario(P):
        async def run(loader, reqs):
            svc = P.service(frozen_clock, loader=loader)
            await svc.start()
            try:
                return [resp_tuple(r) for r in
                        await svc.get_rate_limits(reqs)]
            finally:
                await svc.close()

        loader = P.store.MockLoader()
        first = asyncio.run(run(loader, [
            P.req(name="ld", unique_key=f"u{i}", limit=10, hits=1 + i % 4,
                  duration=60_000, algorithm=i % 2) for i in range(40)]))
        saved = sorted(item_tuple(i) for i in loader.contents)
        frozen_clock.advance(1_500)
        again = asyncio.run(run(P.store.MockLoader(loader.contents), [
            P.req(name="ld", unique_key=f"u{i}", limit=10, hits=1,
                  duration=60_000, algorithm=i % 2) for i in range(40)]))
        return first, saved, again, dict(loader.called)

    got, want = in_turn_mesh(frozen_clock, scenario)
    assert got == want
    assert len(got[1]) == 40 and got[2][0][2] == 10 - 1 - 1


def test_mesh_store_seeding_and_write_through(frozen_clock):
    """Store.get seeds misses on their owner shards; on_change sees every
    post-step state; the object path's answers equal the JAX mesh's."""
    def scenario(P):
        T = P.types
        now = frozen_clock.millisecond_now()
        store = P.store.MockStore()
        for i in range(12):
            key = f"st_seed{i}"
            store.data[key] = T.CacheItem(
                key=key, algorithm=T.Algorithm(i % 2),
                expire_at=now + (60_000 if i != 5 else -1), limit=10,
                duration=60_000, remaining=3.5 if i % 2 else 3,
                created_at=now - 1_000, status=T.Status.UNDER_LIMIT)

        async def run():
            svc = P.service(frozen_clock, store=store)
            await svc.start()
            try:
                out = []
                for j in range(3):
                    reqs = [P.req(name="st", unique_key=f"seed{i}",
                                  limit=10, hits=1 + j % 2,
                                  duration=60_000, algorithm=i % 2)
                            for i in range(12)]
                    reqs += [P.req(name="st", unique_key=f"fresh{i}",
                                   limit=5, hits=2, duration=60_000,
                                   algorithm=i % 2) for i in range(6)]
                    out.append([resp_tuple(r) for r in
                                await svc.get_rate_limits(reqs)])
                    frozen_clock.advance(250)
                return out, svc.backend.snapshot()
            finally:
                await svc.close()

        out, snap = asyncio.run(run())
        return out, snap, sorted(item_tuple(v) for v in store.data.values())

    (out, snap, data), (jout, jsnap, jdata) = in_turn_mesh(frozen_clock,
                                                           scenario)
    assert out == jout and data == jdata
    assert out[0][0][2] == 2 and out[0][5][2] == 9
    for f in jsnap:
        np.testing.assert_array_equal(snap[f], np.asarray(jsnap[f]))


def test_engine_store_seeding_and_sync_write_through(frozen_clock):
    """GLOBAL keys live in the Store but cold on the device: the engine
    seeds BOTH tables (auth owner-routed, cache arrival-routed) before
    serving, and each sync writes the authoritative rows through."""
    def scenario(P):
        T = P.types
        now = frozen_clock.millisecond_now()
        store = P.store.MockStore()
        for i in range(0, 20, 2):
            store.data[f"gl_g{i}"] = T.CacheItem(
                key=f"gl_g{i}", algorithm=T.Algorithm(i % 4 == 0),
                expire_at=now + 60_000, limit=30, duration=60_000,
                remaining=7 if i % 4 else 7.5, created_at=now - 100,
                status=T.Status.UNDER_LIMIT)
        be = P.backend(frozen_clock, store=store)
        eng = P.engine(be, delta_slots=8)
        out = []
        for j in range(3):
            reqs = [P.req(name="gl", unique_key=f"g{i}", hits=1 + j,
                          limit=30, duration=60_000,
                          algorithm=int(i % 4 == 0), behavior=GLOBAL)
                    for i in range(20)]
            out.append([resp_tuple(r) for r in eng.check(reqs)])
            out.append(eng.sync())
            frozen_clock.advance(100)
        return out, sorted(item_tuple(v) for v in store.data.values()), \
            dict(store.called)

    got, want = in_turn_mesh(frozen_clock, scenario)
    assert got == want
    out, data, called = got
    assert out[0][0][2] == 7 - 1  # served from the seeded cache row
    assert len(data) == 20 and called["on_change"] >= 40


def test_mesh_migrate_rows_match_jax_generic(frozen_clock):
    """migrate_extract_rows (gather + expire_at=0 re-upsert) and
    migrate_inject_rows (inject absent, merge resident) on a mesh: the
    returned rows, counts and tables equal the JAX generic paths'."""
    from gubernator_tpu.core.hashing import key_hash64

    def scenario(P):
        be = P.backend(frozen_clock)
        be.check([P.req(name="mg", unique_key=f"k{i}", hits=1 + i % 3,
                        limit=20, duration=60_000, algorithm=i % 2)
                  for i in range(120)])
        fps = np.array([key_hash64(f"mg_k{i}") for i in range(0, 140, 2)],
                       dtype=np.uint64).view(np.int64)
        packed, rf = be.migrate_extract_rows(fps)
        frozen_clock.advance(10)
        cols = {
            "key_hash": fps, "algo": packed[2].astype(np.int32),
            "limit": packed[3], "duration": packed[4],
            "remaining": np.maximum(packed[5] - 1, 0), "remaining_f": rf,
            "t0": packed[6], "status": packed[7].astype(np.int32),
            "burst": packed[8], "expire_at": packed[9],
        }
        cols["key_hash"] = np.where(packed[0] != 0, fps, 0)
        half = {f: a[: len(fps) // 2] for f, a in cols.items()}
        counts = [be.migrate_inject_rows(half),
                  be.migrate_inject_rows(cols)]
        return packed, rf, counts, be.snapshot()

    got, want = in_turn_mesh(frozen_clock, scenario)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[2][1][1] > 0
    assert int(got[0][0].sum()) == 60
    for f in want[3]:
        np.testing.assert_array_equal(got[3][f], np.asarray(want[3][f]))


@pytest.mark.parametrize("mode", ["pipelined", "ring"])
def test_mesh_fast_lane_cold_key_repair(mode, frozen_clock):
    """A Store on the compiled lane over shard-grid rounds: cold keys are
    repaired after the step in both packages, with the same bytes, Store
    contents and tables, and no fallback."""
    from gubernator_tpu.runtime.fastpath import FastPath as JaxFastPath
    from gubernator_tpu_torch.runtime.fastpath import FastPath

    payloads = lane_payloads(7, 16)

    def scenario(P):
        T = P.types
        now = frozen_clock.millisecond_now()
        store = P.store.MockStore()
        for k in range(0, 16, 3):
            store.data[f"ln_k{k}"] = T.CacheItem(
                key=f"ln_k{k}", algorithm=T.Algorithm(k % 2),
                expire_at=now + 60_000, limit=12, duration=60_000,
                remaining=5 if k % 2 == 0 else 5.25, created_at=now - 10,
                status=T.Status.UNDER_LIMIT)

        async def run():
            svc = P.service(frozen_clock, store=store)
            lane = (FastPath if P.port else JaxFastPath)(
                svc, serve_mode=mode, ring_slots=2, ring_rounds=2)
            await svc.start()
            try:
                raw = []
                for i, p in enumerate(payloads):
                    raw.append(await lane.check_raw(p, peer_rpc=False))
                    if i % 4 == 3:
                        frozen_clock.advance(300)
                return raw, (lane.served, lane.fallbacks), \
                    svc.backend.snapshot()
            finally:
                await lane.close()
                await svc.close()

        raw, counts, snap = asyncio.run(run())
        return raw, counts, snap, sorted(
            item_tuple(v) for v in store.data.values())

    (raw, counts, snap, data), (jraw, jcounts, jsnap, jdata) = in_turn_mesh(
        frozen_clock, scenario)
    assert all(r is not None for r in raw) and raw == jraw
    assert counts == jcounts and counts[0] > 0 and counts[1] == 0
    assert data == jdata and len(data) == 16
    for f in jsnap:
        np.testing.assert_array_equal(snap[f], np.asarray(jsnap[f]),
                                      err_msg=f)
