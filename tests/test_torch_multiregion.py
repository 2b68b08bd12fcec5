"""The port's region carve plane (gubernator_tpu_torch/runtime/multiregion.py
and its wiring in the service, the fast lane and the daemon) against the
JAX package's, on the CPU.

The two-region cluster case of tests/test_multiregion.py runs on both
packages, one after the other, on the same gRPC ports and from the same
frozen instant: admitted counts, every answer with its region metadata, the
home region's row and the `/debug/vars` region block are equal.  The
manager-level cases (the rejoin-over-reshard regression, the reconcile
discipline, the lease nesting) run both packages' RegionManager over
tests/test_multiregion.py's fakes.  A partition goes through the port's
chaos injector.
"""
from __future__ import annotations

import asyncio
import json
import socket
import time
import urllib.request
from dataclasses import replace

import pytest
import torch

from gubernator_tpu import daemon as jdaemon
from gubernator_tpu.client import V1Client as JClient
from gubernator_tpu.core import clock as jclock
from gubernator_tpu.core import config as jcfg
from gubernator_tpu.core import types as jt
from gubernator_tpu.runtime import lease as jlease
from gubernator_tpu.runtime import multiregion as jmr
from gubernator_tpu.testing.cluster import Cluster as JCluster
from gubernator_tpu_torch.client import V1Client
from gubernator_tpu_torch.core import clock as pclock
from gubernator_tpu_torch.core import config as pcfg
from gubernator_tpu_torch.core import types as pt
from gubernator_tpu_torch.net import peer_client as ppc
from gubernator_tpu_torch.runtime import lease as please
from gubernator_tpu_torch.runtime import multiregion as pmr
from gubernator_tpu_torch.testing.chaos import ChaosInjector, ChaosPlan
from gubernator_tpu_torch.testing.cluster import Cluster
from test_multiregion import _FakeService, _WanPeer

LIMIT, DURATION = 100, 60_000
FRACTION = 0.25
CARVE = int(LIMIT * FRACTION)
T0_NS = 1_760_000_000_000 * 1_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pkg:
    def __init__(self, port: bool) -> None:
        self.port = port
        self.types = pt if port else jt
        self.cfg = pcfg if port else jcfg
        self.mr = pmr if port else jmr
        self.lease = please if port else jlease
        self.clock = pclock if port else jclock
        self.Client = V1Client if port else JClient

    def device(self):
        if self.port:
            return pcfg.DeviceConfig(num_slots=2048, ways=8, batch_size=64,
                                     platform="cpu")
        return jcfg.DeviceConfig(num_slots=2048, ways=8, batch_size=64)

    def req(self, key, hits=1, limit=LIMIT, **kw):
        return self.types.RateLimitReq(name="t", unique_key=key, hits=hits,
                                       limit=limit, duration=DURATION, **kw)


PORT, JAX = Pkg(True), Pkg(False)


def until_pass(fn, timeout=20.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            return fn()
        except AssertionError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def free_addrs(n: int):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    out = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    return out


def region_conf(P, **kw):
    return P.cfg.DaemonConfig(region=P.cfg.RegionConfig(
        enabled=True, fraction=FRACTION, reconcile_ms=100, drift_max=10_000),
        **kw)


def boot(P, c, conf, dc, addr):
    if P.port:
        return c.boot(P.device(), conf, data_center=dc, grpc_address=addr)

    async def go():
        d = jdaemon.Daemon(replace(
            conf, grpc_listen_address=addr,
            http_listen_address="127.0.0.1:0", data_center=dc,
            behaviors=jcfg.fast_test_behaviors(), device=P.device()))
        await d.start()
        d.conf.advertise_address = d.grpc_address
        return d

    return c.run(go(), timeout=300.0)


def in_regions(P, addrs, body, **conf):
    """body(P, cluster, east, west): a two-region cluster, one node a
    region, on `addrs`, the package's clock frozen at T0_NS."""
    P.clock.freeze(T0_NS)
    c = Cluster() if P.port else JCluster()
    try:
        ds = [boot(P, c, region_conf(P, **conf), dc, a)
              for dc, a in zip(("east", "west"), addrs)]
        c.daemons[:] = ds
        c.run(c._push_peers(), timeout=60.0)
        return body(P, c, *ds)
    finally:
        c.stop()
        P.clock.unfreeze()


def key_homed(rm, region, name="t", skip=0):
    keys = (f"k{i}" for i in range(5000)
            if rm.home_region(f"{name}_k{i}") == region)
    for _ in range(skip):
        next(keys)
    return next(keys)


def resp_tuple(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error,
            dict(r.metadata or {}))


def item_remaining(d, hash_key):
    it = d.service.backend.get_cache_item(hash_key)
    return None if it is None else int(it.remaining)


def test_two_region_carve_exact_matches_jax():
    """A west-homed key checked through east admits exactly the carve on
    both packages, with equal answers and region metadata; the burns
    reconcile into west's row, which reads equal; the region blocks of
    /debug/vars agree; the compiled lane declines every batch."""
    def body(P, c, east, west):
        rm = east.service.regions
        until_pass(lambda: _assert(set(rm.universe()) == {"east", "west"}))
        key = key_homed(rm, "west")
        cl = P.Client(east.grpc_address)
        try:
            resps = [cl.get_rate_limits([P.req(key)], timeout=30)[0]
                     for _ in range(CARVE + 10)]
        finally:
            cl.close()
        admitted = sum(r.status == P.types.Status.UNDER_LIMIT and not r.error
                       for r in resps)

        def reconciled():
            left = item_remaining(west, f"t_{key}")
            assert left is not None and LIMIT - left == CARVE
            assert rm.drift_hits == 0

        until_pass(reconciled)
        with urllib.request.urlopen(
                f"http://{east.http_address}/debug/vars", timeout=10) as f:
            block = json.loads(f.read())["region"]
        carve_row = item_remaining(east, f"t_{key}.region-carve")
        return (key, admitted, [resp_tuple(r) for r in resps],
                item_remaining(west, f"t_{key}"), carve_row,
                {k: block[k] for k in ("name", "universe", "fraction",
                                       "drift", "carve_served",
                                       "reconcile_dropped", "rehomes")},
                east.fastpath.fallbacks > 0 if east.fastpath else None)

    addrs = free_addrs(2)
    got = in_regions(PORT, addrs, body)
    want = in_regions(JAX, addrs, body)
    assert got == want
    key, admitted, resps, home, carve_row, block, declined = got
    assert admitted == CARVE and home == LIMIT - CARVE and carve_row == 0
    assert all(r[5].get("region") == "west"
               and r[5].get("region_serve") == "carve" for r in resps)
    assert block["carve_served"] == CARVE + 10
    assert block["reconcile_dropped"] == 0 and declined is True


def _assert(cond):
    assert cond


def manager(P, name="east", peer=None, fraction=FRACTION, leases=None):
    svc = _FakeService(name=name, peer=peer)
    svc.leases = leases
    cfg = P.cfg.RegionConfig(enabled=True, name=name,
                             peers={"east": [], "west": []},
                             fraction=fraction, reconcile_ms=50,
                             drift_max=10_000)
    return svc, P.mr.RegionManager(svc, cfg)


class _PortWanPeer(_WanPeer):
    """tests/test_multiregion.py's WAN peer raising the PORT's
    PeerNotReadyError when provably unsent (the port's provably_unsent
    recognizes its own error type)."""

    async def get_peer_rate_limits_batch(self, reqs):
        if self.fail == "unsent":
            raise ppc.PeerNotReadyError("peer queue full")
        return await super().get_peer_rate_limits_batch(reqs)


def wan_peer(P, fail=None):
    return (_PortWanPeer if P.port else _WanPeer)(fail=fail)


def test_home_pick_and_carve_serve_match_jax():
    """The rendezvous home pick agrees key for key; a carve serve builds
    the same `.region-carve` request and answers with the same metadata
    and burn."""
    def scenario(P):
        svc, rm = manager(P)
        homes = [rm.home_region(f"t_k{i}") for i in range(400)]
        key = key_homed(rm, "west")
        r = asyncio.run(rm.serve(P.req(key, behavior=P.types.Behavior.GLOBAL),
                                 f"t_{key}", "west"))
        (carve,) = svc.checked[0]
        link = rm._link("west")
        return (homes, key, carve.unique_key, carve.limit,
                int(carve.behavior), int(r.status), dict(r.metadata),
                rm.drift_hits, link.pending[f"t_{key}"].hits,
                rm.carve_slot_keys())

    got = scenario(PORT)
    assert got == scenario(JAX)
    assert set(got[0]) == {"east", "west"}
    assert got[2].endswith(pmr.REGION_SUFFIX) and got[3] == CARVE


@pytest.mark.parametrize("fail", [None, "unsent", "ambiguous"])
def test_reconcile_discipline_matches_jax(fail):
    """tests/test_multiregion.py:346-388 on both managers: a delivery
    settles the drift and strips GLOBAL/MULTI_REGION, a provably unsent
    failure requeues and degrades, an ambiguous one drops."""
    def scenario(P):
        peer = wan_peer(P, fail)
        _, rm = manager(P, peer=peer)
        rm.queue_burn("west", P.req("k", hits=4,
                                    behavior=P.types.Behavior.GLOBAL))
        link = rm._link("west")
        asyncio.run(rm._flush_region("west", rm._take_region("west")))
        wire = [(r.hash_key(), r.hits, int(r.behavior))
                for b in peer.batches for r in b]
        return ({k: r.hits for k, r in link.pending.items()}, rm.drift_hits,
                rm.reconcile_sends, rm.reconcile_dropped, link.state, wire)

    got = scenario(PORT)
    assert got == scenario(JAX)
    pending, drift, sends, dropped, state, wire = got
    if fail is None:
        assert (pending, drift, sends, state) == ({}, 0, 1, "remote")
        assert wire == [("t_k", 4, 0)]
    elif fail == "unsent":
        assert (pending, drift, dropped, state) == ({"t_k": 4}, 4, 0,
                                                    "degraded")
    else:
        assert (pending, drift, dropped, state) == ({}, 0, 4, "remote")


class _FakeLeases:
    def __init__(self) -> None:
        self.dropped = []

    async def drop_rehomed(self, region: str) -> int:
        self.dropped.append(region)
        return 0


def test_rejoin_over_reshard_drops_only_moved_slots_in_both():
    """tests/test_multiregion.py:415 on both managers: at CUTOVER only the
    carve slot whose home moved is dropped; the surviving slot keeps its
    consumed state, and a delivery while degraded rehomes the link."""
    def scenario(P):
        svc, rm = manager(P, peer=wan_peer(P), leases=_FakeLeases())
        still = key_homed(rm, "west")
        moved = key_homed(rm, "east")
        link = rm._link("west")
        link.state = P.mr.REGION_DEGRADED

        def reset(key):
            return replace(P.req(key, hits=0, limit=CARVE),
                           unique_key=key + P.mr.REGION_SUFFIX,
                           behavior=P.types.Behavior.RESET_REMAINING)

        link.resets = {f"t_{still}": reset(still), f"t_{moved}": reset(moved)}
        rm.queue_burn("west", P.req(still, hits=2))
        asyncio.run(rm._rehome("west"))
        return (link.state, rm.rehomes, rm.drift_hits, svc.leases.dropped,
                list(link.resets),
                [[(r.unique_key, int(r.behavior)) for r in b]
                 for b in svc.checked])

    got = scenario(PORT)
    assert got == scenario(JAX)
    state, rehomes, drift, dropped, kept, checked = got
    assert (state, rehomes, drift, dropped) == ("remote", 1, 0, ["west"])
    assert len(kept) == 1 and len(checked) == 1 and len(checked[0]) == 1
    assert checked[0][0][0].endswith(pmr.REGION_SUFFIX)
    assert not checked[0][0][0].startswith(kept[0][2:])


def test_lease_grants_carve_from_region_fraction_in_both():
    """tests/test_multiregion.py:490: a grant for a remote-homed key sizes
    against the region carve, a home key against the full limit."""
    def scenario(P):
        svc, rm = manager(P)
        svc.regions = rm
        lm = P.lease.LeaseManager(svc, P.cfg.LeaseConfig(fraction=0.5))
        remote = P.req(key_homed(rm, "west"))
        home = P.req(key_homed(rm, "east"))
        return (lm._leasable_limit(remote), lm._leasable_limit(home),
                lm.allowance_of(lm._leasable_limit(remote)))

    got = scenario(PORT)
    assert got == scenario(JAX) == (CARVE, LIMIT, 12)


def test_partition_through_port_injector_holds_the_carve():
    """A seeded chaos partition cuts east from west: the carve keeps
    serving, degraded once a reconcile fails, and admits nothing past its
    bound; the provably unsent burns requeue, and after the heal they land
    once and the link rehomes."""
    inj = ChaosInjector(ChaosPlan(seed=7))
    addrs = free_addrs(2)

    def body(P, c, east, west):
        rm = east.service.regions
        until_pass(lambda: _assert(set(rm.universe()) == {"east", "west"}))
        keys = [key_homed(rm, "west", skip=i) for i in range(3)]
        inj.partition({east.grpc_address}, {west.grpc_address})
        cl = P.Client(east.grpc_address)
        try:
            got = [cl.get_rate_limits([P.req(k) for k in keys], timeout=30)
                   for _ in range(CARVE + 5)]
            until_pass(lambda: _assert(
                rm._link("west").state == pmr.REGION_DEGRADED))
            late = cl.get_rate_limits([P.req(k) for k in keys], timeout=30)
            time.sleep(0.3)  # more reconcile windows meet the partition
            during = [item_remaining(west, f"t_{k}") for k in keys]
            drift = rm.drift_hits
            inj.heal()

            def healed():
                assert rm.drift_hits == 0
                assert rm._link("west").state == pmr.REGION_REMOTE
                assert [item_remaining(west, f"t_{k}") for k in keys] \
                    == [LIMIT - CARVE] * 3

            until_pass(healed)
            time.sleep(0.3)  # more windows: nothing applies twice
            after = [item_remaining(west, f"t_{k}") for k in keys]
        finally:
            cl.close()
        admitted = [sum(rs[j].status == pt.Status.UNDER_LIMIT
                        and not rs[j].error for rs in got + [late])
                    for j in range(3)]
        return (admitted, [(int(r.status), r.metadata.get("region_degraded"))
                           for r in late],
                during, drift, after, rm.reconcile_dropped, rm.rehomes,
                inj.injected.get("partition", 0))

    admitted, late, during, drift, after, dropped, rehomes, cut = \
        in_regions(PORT, addrs, body, chaos=inj, circuit=pcfg.CircuitConfig(
            failure_threshold=3, base_backoff_s=0.1, max_backoff_s=1.0,
            jitter=0.2))
    assert admitted == [CARVE] * 3
    assert late == [(int(pt.Status.OVER_LIMIT), "1")] * 3
    assert during == [None] * 3 and drift == 3 * CARVE
    assert after == [LIMIT - CARVE] * 3
    assert dropped == 0 and rehomes >= 1 and cut > 0
