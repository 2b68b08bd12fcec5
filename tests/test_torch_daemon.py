"""The port's daemon (gubernator_tpu_torch/daemon.py) on the CPU over real
gRPC and HTTP on 127.0.0.1, against the JAX daemon.

One node: the reference-schema wire fixture
(tests/fixtures/wire/getratelimits_req.bin) gets the JAX daemon's response
bytes; HealthCheck, the HTTP JSON gateway and the /metrics counters agree.
Three nodes with the same static peers on the same ports: answers forwarded
from node 0 to the key owners, with their owner metadata, are equal, and
GLOBAL keys hit through a non-owner converge to the same owner row and the
same broadcast replica after quiescing.  Each package runs in turn from the
same frozen instant."""
from __future__ import annotations

import asyncio
import os
import socket

import aiohttp
import grpc
import numpy as np
import pytest
import torch

from gubernator_tpu import daemon as jdaemon
from gubernator_tpu.core import config as jcfg
from gubernator_tpu.core.types import PeerInfo as JaxPeerInfo
from gubernator_tpu_torch import daemon as pdaemon
from gubernator_tpu_torch.core import config as pcfg
from gubernator_tpu_torch.core.hashing import key_hash64
from gubernator_tpu_torch.core.types import PeerInfo
from gubernator_tpu_torch.proto import gubernator_pb2 as pb

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "wire")
V1 = "/pb.gubernator.V1/"
GLOBAL = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_ports(n: int):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def conf_for(pkg, grpc_addr, http_addr, peers=()):
    """A DaemonConfig of `pkg` ("port" or "jax"): small CPU table, short
    GLOBAL windows, the stats plane off, the hot-key and lease planes at
    their defaults (on in both), static peers when given."""
    if pkg == "port":
        return pcfg.DaemonConfig(
            grpc_listen_address=grpc_addr, http_listen_address=http_addr,
            advertise_address=grpc_addr if peers else "",
            device=pcfg.DeviceConfig(num_slots=1024, ways=8, batch_size=64,
                                     platform="cpu"),
            behaviors=pcfg.fast_test_behaviors(),
            peer_discovery_type="static" if peers else "none",
            static_peers=list(peers), peer_debounce_ms=0,
            stats=pcfg.StatsConfig(enabled=False))
    return jcfg.DaemonConfig(
        grpc_listen_address=grpc_addr, http_listen_address=http_addr,
        advertise_address=grpc_addr if peers else "",
        device=jcfg.DeviceConfig(num_slots=1024, ways=8, batch_size=64),
        behaviors=jcfg.fast_test_behaviors(),
        peer_discovery_type="static" if peers else "none",
        static_peers=list(peers), peer_debounce_ms=0,
        stats=jcfg.StatsConfig(enabled=False))


async def start(pkg, conf, clock):
    mod = pdaemon if pkg == "port" else jdaemon
    d = mod.Daemon(conf, clock=clock)
    await d.start()
    return d


async def call(addr, method, payload: bytes) -> bytes:
    async with grpc.aio.insecure_channel(addr) as ch:
        return await asyncio.wait_for(
            ch.unary_unary(V1 + method)(payload), 20)


def in_turn(clock, scenario):
    """scenario(pkg) for the port, then for JAX from the same instant."""
    t0 = clock.now_ns()
    got = asyncio.run(asyncio.wait_for(scenario("port"), 90))
    clock.freeze(t0)
    want = asyncio.run(asyncio.wait_for(scenario("jax"), 90))
    return got, want


def test_one_node_wire_health_http_and_metrics(frozen_clock):
    with open(os.path.join(FIX, "getratelimits_req.bin"), "rb") as f:
        fixture = f.read()
    traffic = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
        name="http", unique_key=f"k{i % 4}", hits=1 + i % 2, limit=5,
        duration=60_000, algorithm=i % 2) for i in range(12)]
        + [pb.RateLimitReq(name="", unique_key="x", hits=1, limit=1)])

    async def scenario(pkg):
        g, h = free_ports(2)
        d = await start(pkg, conf_for(pkg, f"127.0.0.1:{g}",
                                      f"127.0.0.1:{h}"), frozen_clock)
        try:
            out = [await call(d.grpc_address, "GetRateLimits", fixture),
                   await call(d.grpc_address, "GetRateLimits",
                              traffic.SerializeToString()),
                   await call(d.grpc_address, "HealthCheck", b"")]
            base = f"http://{d.http_address}"
            async with aiohttp.ClientSession() as s:
                body = '{"requests": [{"name": "http", "unique_key": "k1",' \
                    ' "hits": 2, "limit": 5, "duration": 60000}]}'
                async with s.post(base + "/v1/GetRateLimits",
                                  data=body) as r:
                    out.append(await r.json())
                async with s.get(base + "/v1/HealthCheck") as r:
                    out.append(await r.json())
                # The fixture's GLOBAL key queues an owner broadcast whose
                # hits=0 re-read is one more counted check: let it land
                # before the scrape, in both packages.
                await asyncio.sleep(0.6)
                async with s.get(base + "/metrics") as r:
                    text = await r.text()
                async with s.get(base + "/debug/vars") as r:
                    dvars = await r.json()
            keep = ("gubernator_check_counter",
                    "gubernator_over_limit_counter",
                    "gubernator_getratelimit_counter",
                    "gubernator_check_error_counter")
            out.append(sorted(ln for ln in text.splitlines()
                              if ln.startswith(keep)
                              and "_created" not in ln))
            served = d.fastpath.served
            out.append((dvars["hotkeys"], dvars["leases"]))
            return out, served, dvars
        finally:
            await d.close()

    (got, served, dvars), (want, _, _) = in_turn(frozen_clock, scenario)
    assert got == want
    assert served > 0 and dvars["fastpath"]["fallbacks"] == 0
    assert dvars["backend"]["device"] == "cpu"
    hotkeys, leases = got[-1]
    assert hotkeys["enabled"] and hotkeys["hot_keys"] == 0
    assert leases["grants"] == 0 and leases["keys"] == {}
    assert any("gubernator_check_counter" in ln for ln in got[-2])


def test_three_node_cluster_forwards_and_global_match_jax(frozen_clock):
    """Same static peers, same ports: every answer from node 0 (local,
    forwarded, GLOBAL replica reads) and each owner's GLOBAL row after
    quiescing are equal between the packages."""
    names = [f"t{i}" for i in range(12)]
    stream = [pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
        name=names[(j + i) % 12], unique_key=f"u{i % 3}", hits=1, limit=4,
        duration=60_000, algorithm=(i + j) % 2) for i in range(9)])
        .SerializeToString() for j in range(6)]
    glob = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
        name="g", unique_key=f"gk{i}", hits=1, limit=10, duration=60_000,
        behavior=GLOBAL) for i in range(6)]).SerializeToString()
    ports = free_ports(6)
    grpcs = [f"127.0.0.1:{p}" for p in ports[:3]]
    https = [f"127.0.0.1:{p}" for p in ports[3:]]

    async def scenario(pkg):
        ds = []
        try:
            for g, h in zip(grpcs, https):
                ds.append(await start(pkg, conf_for(pkg, g, h, grpcs),
                                      frozen_clock))
            for _ in range(200):  # static discovery applies the peer set
                if all(len(d.service.peer_list()) == 3 for d in ds):
                    break
                await asyncio.sleep(0.02)
            out = [await call(grpcs[0], "GetRateLimits", p) for p in stream]
            out.append(await call(grpcs[0], "GetRateLimits", glob))
            await asyncio.sleep(0.6)  # hits reach owners, owners broadcast
            out.append(await call(grpcs[0], "GetRateLimits", glob))
            await asyncio.sleep(0.6)
            owners = [ds[0].service.get_peer(f"g_gk{i}").info().grpc_address
                      for i in range(6)]
            rows = []
            for i in range(6):
                fp = np.uint64(key_hash64(f"g_gk{i}")).view(np.int64)
                owner = ds[grpcs.index(owners[i])]
                snap = owner.service.backend.snapshot()
                at = np.flatnonzero(snap["key"] == fp)
                rows.append([int(snap[f][at[0]]) for f in
                             ("kind", "limit", "remaining", "expire_at")]
                            if len(at) else None)
            fwd = sum(len(x.service.peer_list()) for x in ds)
            return out, owners, rows, fwd
        finally:
            for x in ds:
                await x.close()

    got, want = in_turn(frozen_clock, scenario)
    assert got[0] == want[0]       # every answer byte-equal, owner tags too
    assert got[1] == want[1]       # the same owners
    assert got[2] == want[2]       # the same owner rows
    assert got[3] == 9
    owners_elsewhere = [o for o in got[1] if o != grpcs[0]]
    assert owners_elsewhere, "no GLOBAL key owned outside node 0"
    assert all(r is not None and r[0] == 0 for r in got[2])
    replies = [pb.GetRateLimitsResp.FromString(b) for b in got[0][:6]]
    assert any(r.metadata.get("owner") for x in replies
               for r in x.responses)


def test_peer_info_types_are_equal_in_value():
    """The port's PeerInfo mirrors the reference dataclass field by field
    (static discovery and set_peers build it)."""
    a = PeerInfo(grpc_address="h:1", http_address="h:2", data_center="d")
    b = JaxPeerInfo(grpc_address="h:1", http_address="h:2", data_center="d")
    assert vars(a) == vars(b)


def test_port_cluster_fixture_matches_a_single_node(frozen_clock):
    """The port's in-process cluster (testing/cluster.Cluster.start_with):
    sequential RPCs through node 0 get a single-node daemon's answers, the
    owner metadata aside."""
    from gubernator_tpu_torch.testing.cluster import Cluster

    cpu = pcfg.DeviceConfig(num_slots=1024, ways=8, batch_size=64,
                            platform="cpu")
    stream = [pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
        name=f"c{(i + j) % 7}", unique_key=f"u{i % 4}", hits=1 + i % 2,
        limit=5, duration=60_000, algorithm=i % 2) for i in range(10)])
        .SerializeToString() for j in range(5)]

    def strip(raw):
        out = []
        for r in pb.GetRateLimitsResp.FromString(raw).responses:
            md = dict(r.metadata)
            md.pop("owner", None)
            out.append((r.status, r.limit, r.remaining, r.reset_time,
                        r.error, md))
        return out

    c = Cluster.start_with(["", "", ""], device=cpu)
    try:
        for d in c.daemons:
            d.service.clock = frozen_clock  # one frozen instant for all
            d.service.backend.clock = frozen_clock
        got = [strip(c.run(call(c.addresses()[0], "GetRateLimits", p)))
               for p in stream]
    finally:
        c.stop()

    async def single():
        g, h = free_ports(2)
        d = await start("port", conf_for("port", f"127.0.0.1:{g}",
                                         f"127.0.0.1:{h}"), frozen_clock)
        try:
            return [strip(await call(d.grpc_address, "GetRateLimits", p))
                    for p in stream]
        finally:
            await d.close()

    want = asyncio.run(asyncio.wait_for(single(), 60))
    assert got == want
