"""The port's service and daemon on a sharded table (num_shards = 4) on the
CPU, against the JAX package's on conftest's virtual CPU devices.

Both packages' `Service` at num_shards=4 with the planes at their defaults:
the object path answers alike and routes node-owned GLOBAL keys through the
collective engine; the compiled lane serves shard-grid rounds and the engine
lane (pipelined, megaround, and persistent declining to megaround as in the
JAX package) with the JAX lane's bytes and tables; two mesh daemons bridge
their engines' syncs to each other over the RPC tier (`_engine_synced`);
and a daemon configured with GUBER_MESH_WAYS=4 serves GetRateLimits in the
pipelined, ring and megaround modes and reports its per-shard occupancy in
/debug/vars and /metrics.

The collective loop's window is set long and syncs come from the batch
limit or from the test, so both packages sync at the same stream points."""
from __future__ import annotations

import asyncio

import aiohttp
import numpy as np
import pytest
import torch
from test_torch_daemon import call, free_ports
from test_torch_fastpath import SKETCH, payload_stream, serve_stream

from gubernator_tpu.core import config as jcfg
from gubernator_tpu.core import types as jt
from gubernator_tpu.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.core import config as pcfg
from gubernator_tpu_torch.core import types as pt

SHARDS, SLOTS, WAYS, B = 4, 1024, 8, 64
GLOBAL = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def behaviors(mod):
    """Syncs at the batch limit (or the test's own call), never on the
    wall-clock window."""
    return mod.BehaviorConfig(global_sync_wait_s=1000.0,
                              global_batch_limit=7)


def service(port: bool, clock):
    geo = dict(num_slots=SLOTS, ways=WAYS, batch_size=B, num_shards=SHARDS)
    if port:
        from gubernator_tpu_torch.runtime.service import Service

        return Service(pcfg.Config(
            device=pcfg.DeviceConfig(platform="cpu", **geo),
            sketch=pcfg.SketchTierConfig(**SKETCH),
            behaviors=behaviors(pcfg)), clock=clock)
    from gubernator_tpu.runtime.service import Service

    return Service(jcfg.Config(
        device=jcfg.DeviceConfig(**geo),
        sketch=jcfg.SketchTierConfig(**SKETCH),
        behaviors=behaviors(jcfg)), clock=clock)


def state(svc):
    """(auth table, engine cache table) host copies."""
    eng = svc.global_engine
    cache = {f: np.array(getattr(eng.cache_table, f))
             for f in eng.cache_table._fields}
    return svc.backend.snapshot(), cache


def assert_same_state(got, want):
    for g, w in zip(got, want):
        for f in w:
            np.testing.assert_array_equal(np.asarray(g[f]),
                                          np.asarray(w[f]), err_msg=f)


def in_turn(clock, scenario, timeout=90):
    t0 = clock.now_ns()
    got = asyncio.run(asyncio.wait_for(scenario(True), timeout))
    clock.freeze(t0)
    return got, asyncio.run(asyncio.wait_for(scenario(False), timeout))


def test_services_at_four_shards_match_jax(frozen_clock):
    """The object path on both packages' mesh services: exact keys on
    their owner shards, node-owned GLOBAL keys through the engine (served
    from the replicated cache, synced at the batch limit and at the end):
    every answer, the auth table and the cache table equal."""
    async def scenario(port):
        T = pt if port else jt
        svc = service(port, frozen_clock)
        await svc.start()
        try:
            out = []
            for j in range(8):
                reqs = [T.RateLimitReq(
                    name="ms", unique_key=f"k{(i * 7 + j) % 30}",
                    hits=1 + (i + j) % 3, limit=12, duration=60_000,
                    algorithm=(i + j) % 2,
                    behavior=GLOBAL if i % 4 == 0 else 0)
                    for i in range(24)]
                out.append([(int(r.status), r.limit, r.remaining,
                             r.reset_time, r.error)
                            for r in await svc.get_rate_limits(reqs)])
                frozen_clock.advance(120)
            out.append(svc.global_engine.sync())
            eng = svc.global_engine
            counts = (eng.syncs, eng.sync_keys, svc.backend.checks)
            return out, counts, state(svc)
        finally:
            await svc.close()

    (out, counts, st), (jout, jcounts, jst) = in_turn(frozen_clock,
                                                      scenario)
    assert out == jout and counts == jcounts
    assert counts[0] >= 3
    assert_same_state(st, jst)


@pytest.mark.parametrize("mode", ["pipelined", "megaround", "persistent"])
def test_compiled_lane_matches_jax(mode, frozen_clock):
    """The compiled lane on mesh services: shard-grid rounds for exact
    and sketch traffic, the engine lane for GLOBAL; the bytes, the auth
    table and the cache table equal the JAX lane's.  persistent declines
    to megaround, with the JAX reason, in both."""
    from gubernator_tpu.runtime.fastpath import FastPath as JaxFastPath
    from gubernator_tpu_torch.runtime.fastpath import FastPath

    payloads = payload_stream(len(mode), 10)

    async def scenario(port):
        svc = service(port, frozen_clock)
        fp = (FastPath if port else JaxFastPath)(
            svc, serve_mode=mode, ring_slots=2, ring_rounds=2)
        try:
            got = await serve_stream(svc, fp, payloads, frozen_clock)
            return got, state(svc), fp.effective_serve_mode, \
                fp.persistent_status, (fp.served, fp.fallbacks), \
                fp.blocking_fetches
        finally:
            await fp.close()
            await svc.close()

    (got, st, eff, pst, counts, blocking), \
        (want, jst, jeff, jpst, jcounts, _) = in_turn(frozen_clock, scenario)
    assert all(g is not None for g in got) and got == want
    assert_same_state(st, jst)
    assert eff == jeff == ("megaround" if mode == "persistent" else mode)
    assert counts == jcounts and counts[0] > 0 and counts[1] == 0
    if mode != "pipelined":
        assert sum(blocking.values()) == 0
    else:
        assert blocking["engine"] > 0
    if mode == "persistent":
        assert pst["supported"] is False
        assert pst["reason"] == jpst["reason"] and "mesh" in pst["reason"]


def test_engine_synced_bridge_on_two_nodes(frozen_clock):
    """Two mesh daemons on the same ports in each package: GLOBAL hits
    through node 0 reach their owner, the owner's collective sync applies
    them, and `_engine_synced` queues the authoritative statuses for the
    RPC broadcast to the other node.  Flushes run at fixed stream points;
    the answers, both nodes' replicated rows and pending queues equal the
    JAX cluster's."""
    ports = free_ports(4)
    grpcs = [f"127.0.0.1:{p}" for p in ports[:2]]
    https = [f"127.0.0.1:{p}" for p in ports[2:]]
    keys = [f"mg{i}" for i in range(6)]

    def conf(port, g, h):
        mod = pcfg if port else jcfg
        geo = dict(num_slots=SLOTS, ways=WAYS, batch_size=B,
                   num_shards=SHARDS)
        return mod.DaemonConfig(
            grpc_listen_address=g, http_listen_address=h,
            advertise_address=g, behaviors=mod.fast_test_behaviors(),
            device=(mod.DeviceConfig(platform="cpu", **geo) if port
                    else mod.DeviceConfig(**geo)),
            peer_discovery_type="static", static_peers=list(grpcs),
            peer_debounce_ms=0, stats=mod.StatsConfig(enabled=False))

    async def scenario(port):
        if port:
            from gubernator_tpu_torch.daemon import Daemon
        else:
            from gubernator_tpu.daemon import Daemon
        ds = []
        try:
            for g, h in zip(grpcs, https):
                d = Daemon(conf(port, g, h), clock=frozen_clock)
                await d.start()
                ds.append(d)
            for _ in range(200):
                if all(len(d.service.peer_list()) == 2 for d in ds):
                    break
                await asyncio.sleep(0.02)
            for d in ds:  # flushes at fixed stream points only
                svc = d.service
                lp = svc._collective_loop
                lp._task.cancel()
                await asyncio.gather(lp._task, return_exceptions=True)
                lp._task = None
                for t in svc.global_mgr._tasks:
                    t.cancel()
                await asyncio.gather(*svc.global_mgr._tasks,
                                     return_exceptions=True)
                svc.global_mgr._tasks = []
            loop = asyncio.get_running_loop()
            outs = []
            for step in range(4):
                payload = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
                    name="mg", unique_key=keys[(i + step) % 6],
                    hits=1 + i % 2, limit=50, duration=60_000,
                    behavior=GLOBAL) for i in range(9)]).SerializeToString()
                outs.append(await call(grpcs[0], "GetRateLimits", payload))
                for d in ds:
                    mgr = d.service.global_mgr
                    hits = mgr._take_hits()
                    if hits:
                        await mgr._send_hits(hits)
                for d in ds:
                    await loop.run_in_executor(
                        d.service._dev_executor,
                        d.service.global_engine.sync)
                await asyncio.sleep(0)  # let _engine_synced land
                bridged = sum(len(d.service.global_mgr._updates)
                              for d in ds)
                for d in ds:
                    mgr = d.service.global_mgr
                    upd = mgr._take_updates()
                    if upd:
                        await mgr._broadcast_peers(upd)
                rows = []
                for d in ds:
                    for k in keys:
                        it = d.service.backend.get_cache_item(f"mg_{k}")
                        rows.append((it.remaining, it.expire_at,
                                     int(it.status)) if it else None)
                outs.append((bridged, rows))
                frozen_clock.advance(100)
            return outs
        finally:
            for d in ds:
                await d.close()

    got, want = in_turn(frozen_clock, scenario, timeout=120)
    assert got == want
    assert sum(b for b, _ in got[1::2]) > 0  # the bridge queued updates
    assert any(r is not None for _, rows in got[1::2] for r in rows)


@pytest.mark.parametrize("mode", ["pipelined", "ring", "megaround"])
def test_daemon_under_mesh_ways_env(mode, frozen_clock, monkeypatch):
    """GUBER_MESH_WAYS=4 builds a mesh daemon that serves GetRateLimits in
    each serve mode with the JAX daemon's bytes; /debug/vars
    `backend.shard_occupancy` has 4 entries summing to the occupancy, as
    in the JAX daemon, and /metrics carries the per-shard gauges."""
    g, h = free_ports(2)
    for k, v in dict(GUBER_MESH_WAYS="4", GUBER_TPU_NUM_SLOTS=str(SLOTS),
                     GUBER_SERVE_MODE=mode, GUBER_RING_SLOTS="2",
                     GUBER_RING_ROUNDS="2",
                     GUBER_TPU_BATCH_SIZE=str(B), GUBER_TPU_PLATFORM="cpu",
                     GUBER_GRPC_ADDRESS=f"127.0.0.1:{g}",
                     GUBER_HTTP_ADDRESS=f"127.0.0.1:{h}",
                     GUBER_STATS_ENABLED="false").items():
        monkeypatch.setenv(k, v)
    payload = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
        name="env", unique_key=f"k{i}", hits=1, limit=5, duration=60_000,
        algorithm=i % 2) for i in range(40)]).SerializeToString()

    async def scenario(port):
        if port:
            from gubernator_tpu_torch.core.config import setup_daemon_config
            from gubernator_tpu_torch.daemon import Daemon
        else:
            from gubernator_tpu.core.config import setup_daemon_config
            from gubernator_tpu.daemon import Daemon
        conf = setup_daemon_config()
        assert conf.device.num_shards == SHARDS
        d = Daemon(conf, clock=frozen_clock)
        await d.start()
        try:
            resp = await call(d.grpc_address, "GetRateLimits", payload)
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://{d.http_address}/debug/vars") as r:
                    dvars = await r.json()
                async with s.get(f"http://{d.http_address}/metrics") as r:
                    text = await r.text()
            shard_lines = sorted(ln for ln in text.splitlines()
                                 if ln.startswith("gubernator_shard_occ"))
            return (resp, dvars["backend"], shard_lines,
                    d.fastpath.effective_serve_mode)
        finally:
            await d.close()

    (resp, be, lines, eff), (jresp, jbe, jlines, jeff) = in_turn(
        frozen_clock, scenario)
    assert resp == jresp and eff == jeff == mode
    assert len(be["shard_occupancy"]) == SHARDS
    assert be["shard_occupancy"] == jbe["shard_occupancy"]
    assert sum(be["shard_occupancy"]) == be["occupancy"] >= 40
    assert lines == jlines and len(lines) == SHARDS
