"""The port's live resharding (gubernator_tpu_torch/runtime/reshard.py over
the backend's migrate_extract_rows / migrate_inject_rows, the service's
Handoff/Migrate receive and covered-key serving, the daemon's drain)
against the JAX package's, on the CPU.

The scenarios of tests/test_reshard.py run on both packages from one
frozen instant.  The cluster scenarios boot each package's daemons on the
SAME gRPC ports (the ring places keys by hashing the addresses), one
package after the other: a join moves counters to the new owner, a
graceful leave drains them to the survivors, a drain on close ships them
before the listeners stop.  Rows, answers and counters are equal; the
handoff window's double admission lands exactly on
limit x (1 + handoff_fraction)."""
from __future__ import annotations

import asyncio
import socket
import time
from dataclasses import replace

import numpy as np
import pytest
import torch

from gubernator_tpu import daemon as jdaemon
from gubernator_tpu.client import V1Client
from gubernator_tpu.core import clock as jclock
from gubernator_tpu.core import config as jcfg
from gubernator_tpu.core import types as jt
from gubernator_tpu.net.replicated_hash import ReplicatedConsistentHash as JRing
from gubernator_tpu.runtime import reshard as jreshard
from gubernator_tpu.runtime.backend import DeviceBackend
from gubernator_tpu.runtime.service import ApiError as JaxApiError
from gubernator_tpu.runtime.service import Service as JaxService
from gubernator_tpu.testing.cluster import Cluster as JCluster
from gubernator_tpu_torch import daemon as pdaemon
from gubernator_tpu_torch.core import clock as pclock
from gubernator_tpu_torch.core import config as pcfg
from gubernator_tpu_torch.core import types as pt
from gubernator_tpu_torch.net.replicated_hash import (
    ReplicatedConsistentHash,
    xx_64,
)
from gubernator_tpu_torch.proto import peers_pb2
from gubernator_tpu_torch.runtime import reshard as preshard
from gubernator_tpu_torch.runtime.backend import TorchBackend
from gubernator_tpu_torch.runtime.service import ApiError, Service
from gubernator_tpu_torch.testing.cluster import Cluster

LIMIT, DURATION = 100, 60_000
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
        self.reshard = preshard if port else jreshard
        self.clock = pclock if port else jclock

    def device(self, slots=2048):
        if self.port:
            return pcfg.DeviceConfig(num_slots=slots, ways=8, batch_size=64,
                                     platform="cpu")
        return jcfg.DeviceConfig(num_slots=slots, ways=8, batch_size=64)

    def daemon_conf(self, **reshard):
        return self.cfg.DaemonConfig(
            reshard=self.cfg.ReshardConfig(**reshard))

    def req(self, key, hits=1, limit=LIMIT):
        return self.types.RateLimitReq(name="t", unique_key=key, hits=hits,
                                       limit=limit, duration=DURATION)


PORT, JAX = Pkg(True), Pkg(False)


class FakePeer:
    def __init__(self, PeerInfo, addr: str, is_owner: bool = False) -> None:
        self._info = PeerInfo(grpc_address=addr, is_owner=is_owner)

    def info(self):
        return self._info


def picker(P, addrs, me=None):
    ring = (ReplicatedConsistentHash if P.port else JRing)(xx_64)
    for a in addrs:
        ring.add(FakePeer(P.types.PeerInfo, a, is_owner=(a == me)))
    return ring


def fp(key: str) -> int:
    return int(np.uint64(xx_64(key.encode())).view(np.int64))


def item_tuple(it):
    if it is None:
        return None
    return (it.key, int(it.algorithm), it.expire_at, it.limit, it.duration,
            float(it.remaining), it.created_at, int(it.status), it.burst)


def test_compute_moved_matches_jax():
    me, other, joiner = "10.0.0.1:1051", "10.0.0.2:1051", "10.0.0.3:1051"
    fps = np.array([fp(f"t_k{i}") for i in range(600)], dtype=np.int64)

    def scenario(P):
        old = picker(P, [me, other], me=me)
        new = picker(P, [me, other, joiner], me=me)
        moved = P.reshard.compute_moved(fps, old, new)
        return ({a: sorted(int(f) for f in v) for a, v in moved.items()},
                P.reshard.compute_moved(fps, old, picker(P, [me, other],
                                                         me=me)),
                P.reshard.compute_moved(fps[:0], old, new))

    got = scenario(PORT)
    assert got == scenario(JAX)
    assert set(got[0]) <= {other, joiner}
    assert 0 < len(got[0][joiner]) < len(fps) and got[1] == got[2] == {}


def test_backend_extract_clears_and_inject_merges(frozen_clock):
    """migrate_extract_rows gathers and clears; migrate_inject_rows lands
    absent rows and merges resident ones (consumption summed, clamped)."""
    def scenario(P):
        cls = TorchBackend if P.port else DeviceBackend
        be = cls(P.device(), clock=frozen_clock)
        reqs = [P.req(f"k{i}", hits=3 + i % 4) for i in range(10)]
        be.check(reqs)
        fps = np.array([fp(r.hash_key()) for r in reqs], dtype=np.int64)
        occ0 = be.occupancy()
        packed, rf = be.migrate_extract_rows(fps[:6])
        out = [packed, rf, occ0 - be.occupancy(),
               item_tuple(be.get_cache_item(reqs[0].hash_key()))]
        cols = {"key_hash": fps[:6], "algo": packed[2].astype(np.int32),
                "limit": packed[3], "duration": packed[4],
                "remaining": packed[5], "remaining_f": rf, "t0": packed[6],
                "status": packed[7].astype(np.int32), "burst": packed[8],
                "expire_at": packed[9]}
        be2 = cls(P.device(), clock=frozen_clock)
        out.append(be2.migrate_inject_rows(cols))
        out.append(be2.check([P.req("k0", hits=1)])[0].remaining)
        be3 = cls(P.device(), clock=frozen_clock)
        be3.check([P.req("k0", hits=5), P.req("k1", hits=99)])
        out.append(be3.migrate_inject_rows(cols))
        out += [item_tuple(be3.get_cache_item(r.hash_key()))
                for r in reqs[:6]]
        return out, be3.snapshot()

    t0 = frozen_clock.now_ns()
    (got, snap) = scenario(PORT)
    frozen_clock.freeze(t0)
    (want, jsnap) = scenario(JAX)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]
    for f in jsnap:
        np.testing.assert_array_equal(snap[f], jsnap[f], err_msg=f)
    assert got[2] == 6 and got[3] is None and got[4] == (6, 0)
    assert got[5] == LIMIT - 3 - 1 and got[6] == (4, 2)
    assert got[7][5] == LIMIT - 5 - 3 and got[8][5] == 0  # clamped


def rows_pb(P, reqs, remaining, now):
    return peers_pb2.MigratedRows(
        key_hash=[fp(r.hash_key()) for r in reqs], algo=[0] * len(reqs),
        limit=[r.limit for r in reqs], duration=[r.duration for r in reqs],
        remaining=[remaining] * len(reqs), remaining_f=[0.0] * len(reqs),
        t0=[now] * len(reqs), status=[0] * len(reqs), burst=[0] * len(reqs),
        expire_at=[now + DURATION] * len(reqs),
        keys=[r.hash_key() for r in reqs])


def test_inbound_state_machine_walk(frozen_clock):
    """PREPARE, stale epochs refused, TRANSFER, chunk inject and replay,
    serving the injected rows, idempotent CUTOVER, and the watchdog's
    self-cutover once the frozen clock passes the deadline."""
    old = "10.9.9.9:1051"

    def scenario(P):
        rcfg = P.cfg.ReshardConfig(timeout_s=5.0, release_linger_s=1.0)
        if P.port:
            svc = Service(pcfg.Config(device=P.device(), reshard=rcfg),
                          clock=frozen_clock)
        else:
            svc = JaxService(jcfg.Config(
                device=P.device(), reshard=rcfg), clock=frozen_clock)

        async def run():
            await svc.start()
            try:
                rs, now = svc.reshard, frozen_clock.millisecond_now()
                out = [await svc.handoff(old, 7, "prepare", 0), rs.active(),
                       await svc.handoff(old, 6, "transfer", 0)]
                try:
                    await svc.migrate(old, 6, rows_pb(P, [P.req("a")], 50,
                                                      now), False)
                except (ApiError, JaxApiError) as e:
                    out.append(e.code)
                out.append(await svc.handoff(old, 7, "transfer", 2))
                reqs = [P.req("a"), P.req("b")]
                out.append(await svc.migrate(old, 7, rows_pb(P, reqs, 50,
                                                             now), False))
                out.append(await svc.migrate(old, 7, rows_pb(P, reqs, 50,
                                                             now), True))
                out.append((await svc._check_local(
                    [P.req("a", hits=1)]))[0].remaining)
                out += [await svc.handoff(old, 7, "cutover", 0),
                        len(rs._inbound),
                        await svc.handoff(old, 7, "cutover", 0)]
                out += [await svc.handoff(old, 8, "prepare", 0),
                        await svc.handoff(old, 8, "transfer", 0),
                        await rs.check_timeouts()]
                frozen_clock.advance(6000)
                out += [await rs.check_timeouts(), len(rs._inbound),
                        rs.self_cutovers]
                return out
            finally:
                await svc.close()

        return asyncio.run(run())

    t0 = frozen_clock.now_ns()
    got = scenario(PORT)
    frozen_clock.freeze(t0)
    want = scenario(JAX)
    assert got == want
    assert got[0] == (True, "prepare") and got[3] == "FAILED_PRECONDITION"
    assert got[5:8] == [(2, 0), (0, 2), 49] and got[-3:] == [1, 0, 1]


class SlowPeer:
    """A new owner that accepts every Migrate chunk, each after `delay_s`."""

    def __init__(self, delay_s: float) -> None:
        self.delay_s = delay_s
        self.at = []

    async def migrate(self, me, epoch, rows, final=False):
        await asyncio.sleep(self.delay_s)
        self.at.append(time.monotonic())
        return len(rows.key_hash), 0


def test_transfer_deadline_counts_the_whole_transfer_in_both(frozen_clock):
    """ReshardConfig.timeout_s is documented as the silence after which a
    handoff gives up, but the sender's _transfer_rows starts ONE deadline
    for the whole transfer: a new owner that takes every chunk, never
    silent for timeout_s, still loses the rows past it (ROADMAP queue 3).
    Both packages alike."""
    timeout_s, delay_s, n = 1.0, 0.2, 10

    def scenario(P):
        rcfg = P.cfg.ReshardConfig(timeout_s=timeout_s, chunk_rows=1)
        if P.port:
            svc = Service(pcfg.Config(device=P.device(), reshard=rcfg),
                          clock=frozen_clock)
        else:
            svc = JaxService(jcfg.Config(
                device=P.device(), reshard=rcfg), clock=frozen_clock)
        reqs = [P.req(f"d{i}") for i in range(n)]
        fps = np.array([fp(r.hash_key()) for r in reqs], dtype=np.int64)
        peer = SlowPeer(delay_s)

        async def run():
            await svc.start()
            try:
                await svc._check_local(reqs)
                svc.backend.migrate_extract_rows(np.ones(1, np.int64))  # warm
                rs = svc.reshard
                ob = P.reshard._Outbound(to_addr="10.9.9.9:1051", epoch=1,
                                         fp_set=set(fps.tolist()), n_rows=n)
                t0 = time.monotonic()
                try:
                    await rs._transfer_rows(peer, ob, "me:1", fps)
                    raised = None
                except RuntimeError as e:
                    raised = str(e).split(":")[0]
                gaps = np.diff([t0] + peer.at)
                return (raised, ob.rows_lost, rs.rows_lost,
                        len(peer.at) < n, float(gaps.max()) < timeout_s)
            finally:
                await svc.close()

        return asyncio.run(run())

    t0 = frozen_clock.now_ns()
    got = scenario(PORT)
    frozen_clock.freeze(t0)
    assert got == scenario(JAX)
    assert got == ("transfer deadline", 1, 1, True, True)


# -- clusters on fixed ports --------------------------------------------------

def free_addrs(n: int):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    out = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    return out


def boot(P, c, conf, addr):
    """One daemon of package P on the cluster loop at `addr`, not yet in
    anyone's peer set."""
    if P.port:
        return c.boot(P.device(), conf, grpc_address=addr)

    async def go():
        d = jdaemon.Daemon(replace(
            conf, grpc_listen_address=addr,
            http_listen_address="127.0.0.1:0",
            behaviors=jcfg.fast_test_behaviors(), device=P.device()))
        await d.start()
        d.conf.advertise_address = d.grpc_address
        return d

    return c.run(go(), timeout=300.0)


def set_members(c, daemons):
    c.daemons[:] = daemons
    c.run(c._push_peers(), timeout=60.0)


def until_pass(fn, timeout=20.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            return fn()
        except AssertionError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def settled(d):
    rs = d.service.reshard
    assert rs.handoffs_started > 0
    assert rs.handoffs_started == rs.handoffs_completed + rs.handoffs_aborted


def in_cluster(P, addrs, body, **reshard):
    """body(P, cluster, daemons) with len(addrs) daemons booted on `addrs`
    (none joined), both packages' clocks frozen at T0_NS."""
    P.clock.freeze(T0_NS)
    c = Cluster() if P.port else JCluster()
    try:
        conf = P.daemon_conf(**reshard)
        ds = [boot(P, c, conf, a) for a in addrs]
        return body(P, c, ds)
    finally:
        c.stop()
        P.clock.unfreeze()


def both_clusters(n, body, **reshard):
    addrs = free_addrs(n)
    return (in_cluster(PORT, addrs, body, **reshard),
            in_cluster(JAX, addrs, body, **reshard))


def test_join_migrates_counters(frozen_clock):
    """A join moves the keys of d0's arcs that d2 now owns, row for row
    (remaining, t0, expire_at), purges them at d0, and later checks
    through d1 continue the same windows at d2."""
    def body(P, c, ds):
        d0, d1, d2 = ds
        set_members(c, [d0, d1])
        two = [d0.grpc_address, d1.grpc_address]
        three = two + [d2.grpc_address]
        keys = [f"k{i}" for i in range(400)
                if picker(P, two).get(f"t_k{i}").info().grpc_address
                == two[0]][:40]
        moving = [k for k in keys if picker(P, three).get(
            f"t_{k}").info().grpc_address == three[2]]
        cl = V1Client(d1.grpc_address)
        try:
            for j, k in enumerate(keys):
                cl.get_rate_limits([jt.RateLimitReq(
                    name="t", unique_key=k, hits=1 + j % 9, limit=LIMIT,
                    duration=DURATION, algorithm=j % 2)], timeout=30)
            pre = [item_tuple(d0.service.backend.get_cache_item(f"t_{k}"))
                   for k in keys]
            set_members(c, [d0, d1, d2])
            until_pass(lambda: settled(d0))
            rs0 = d0.service.reshard
            rows = [(item_tuple(d2.service.backend.get_cache_item(f"t_{k}")),
                     item_tuple(d0.service.backend.get_cache_item(f"t_{k}")))
                    for k in moving]
            after = cl.get_rate_limits([jt.RateLimitReq(
                name="t", unique_key=k, hits=1, limit=LIMIT,
                duration=DURATION, algorithm=keys.index(k) % 2)
                for k in moving], timeout=30)
            return (keys, moving, pre, rows,
                    [(r.status, r.remaining, r.reset_time, r.error,
                      r.metadata.get("owner")) for r in after],
                    rs0.rows_sent, rs0.rows_lost, rs0.handoffs_completed)
        finally:
            cl.close()

    got, want = both_clusters(3, body, timeout_s=10.0, release_linger_s=1.0)
    assert got == want
    keys, moving, pre, rows, after, sent, lost, done = got
    assert moving and sent >= len(moving) and lost == 0 and done >= 1
    for k, (new, old) in zip(moving, rows):
        assert old is None and new == pre[keys.index(k)]


def test_double_admission_bound_exact():
    """The handoff window held open: a fully consumed key admits exactly
    handoff_fraction x limit more through the new owner's shadow, and the
    cutover leaves the row saturated, not inflated."""
    fraction = 0.25

    def body(P, c, ds):
        d0, d1, d2 = ds
        set_members(c, [d0, d1])
        two = [d0.grpc_address, d1.grpc_address]
        three = two + [d2.grpc_address]
        key = next(f"k{i}" for i in range(5000)
                   if picker(P, two).get(f"t_k{i}").info().grpc_address
                   == two[0] and picker(P, three).get(
                       f"t_k{i}").info().grpc_address == three[2])
        cl = V1Client(d1.grpc_address)
        req = [jt.RateLimitReq(name="t", unique_key=key, hits=1, limit=LIMIT,
                               duration=DURATION)]
        try:
            admitted = sum(
                cl.get_rate_limits(req, timeout=30)[0].status == 0
                for _ in range(LIMIT + 10))
            gate = c.run(_event())
            d0.service.reshard.transfer_gate = gate
            set_members(c, [d0, d1, d2])

            def in_transfer():
                ib = d2.service.reshard._inbound.get(d0.grpc_address)
                assert ib is not None and ib.phase == "transfer"

            until_pass(in_transfer)
            shadow, tagged = 0, 0
            for _ in range(int(LIMIT * fraction) + 20):
                r = cl.get_rate_limits(req, timeout=30)[0]
                shadow += r.status == 0 and not r.error
                tagged += r.metadata.get("reshard") == "handoff-shadow"
            c.run(_set(gate))
            until_pass(lambda: settled(d0))

            def reconciled():
                assert not d2.service.reshard._inbound
                row = d2.service.backend.get_cache_item(f"t_{key}")
                assert row is not None and int(row.remaining) == 0

            until_pass(reconciled)
            last = cl.get_rate_limits(req, timeout=30)[0].status
            return admitted, shadow, tagged, last
        finally:
            cl.close()

    addrs = free_addrs(3)
    admitted, shadow, tagged, last = in_cluster(
        PORT, addrs, body, handoff_fraction=fraction, timeout_s=30.0,
        release_linger_s=1.0)
    assert admitted == LIMIT and shadow == int(LIMIT * fraction)
    assert tagged >= shadow and last == 1


async def _event():
    return asyncio.Event()


async def _set(ev):
    ev.set()


@pytest.mark.parametrize("how", ["drain_then_leave", "drain_on_close"])
def test_leave_drains_counters_to_survivors(how):
    """A graceful leave, by drain() then a remap or by closing a daemon
    configured to drain on close, ships every owned row to the ring
    without it; the survivors continue the windows."""
    def body(P, c, ds):
        set_members(c, ds)
        d2 = ds[2]
        ring = [d.grpc_address for d in ds]
        keys = [f"k{i}" for i in range(300)
                if picker(P, ring).get(f"t_k{i}").info().grpc_address
                == ring[2]][:25]
        cl = V1Client(ds[0].grpc_address)
        try:
            for j, k in enumerate(keys):
                cl.get_rate_limits([jt.RateLimitReq(
                    name="t", unique_key=k, hits=2 + j, limit=LIMIT,
                    duration=DURATION)], timeout=30)
            pre = [item_tuple(d2.service.backend.get_cache_item(f"t_{k}"))
                   for k in keys]
            if how == "drain_then_leave":
                shipped = c.run(d2.drain(), timeout=60.0)
                gone = [d2.service.backend.get_cache_item(f"t_{k}")
                        for k in keys]
                set_members(c, ds[:2])
                c.run(d2.close(), timeout=60.0)
            else:
                d2.conf = replace(d2.conf, reshard_drain_on_close=True)
                rs = d2.service.reshard
                c.run(d2.close(), timeout=60.0)
                shipped, gone = rs.rows_sent, []
                set_members(c, ds[:2])
            left = ring[:2]
            rows = []
            for k in keys:
                owner = ds[left.index(picker(P, left).get(
                    f"t_{k}").info().grpc_address)]
                rows.append(item_tuple(
                    owner.service.backend.get_cache_item(f"t_{k}")))
            after = cl.get_rate_limits([jt.RateLimitReq(
                name="t", unique_key=k, hits=1, limit=LIMIT,
                duration=DURATION) for k in keys], timeout=30)
            return (keys, shipped, gone, pre, rows,
                    [(r.status, r.remaining, r.error) for r in after])
        finally:
            cl.close()

    got, want = both_clusters(3, body, timeout_s=10.0, release_linger_s=5.0)
    assert got == want
    keys, shipped, gone, pre, rows, after = got
    assert keys and shipped >= len(keys) and not any(gone)
    assert rows == pre
    assert [a[1] for a in after] == [LIMIT - 2 - j - 1
                                     for j in range(len(keys))]
