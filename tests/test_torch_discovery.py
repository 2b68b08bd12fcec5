"""The port's discovery pools (gubernator_tpu_torch/discovery/) and their
wiring in the daemon, against the JAX package's, on the CPU.

Every case runs the JAX package's pool (or daemons) and then the port's on
the same inputs: the same fake resolver, the same fake `kubernetes` and
`etcd3` modules (tests/test_discovery_fakes.py's), the same gossip packets
and ports.  The published peer lists (address, http address, is_owner,
data center) must be equal; a few literal asserts pin what both publish.
Gossip runs live over UDP, as tests/test_gossip.py drives the JAX pool, on
ports of its own so both files can run at once, and scripted packet by
packet on a frozen clock.  Three daemons per package configured by
GUBER_PEER_DISCOVERY_TYPE=gossip converge and route a check."""
from __future__ import annotations

import asyncio
import json
import socket
import sys
import types
from dataclasses import asdict

import pytest
import torch

import test_discovery_fakes as fakes
from gubernator_tpu import client as jclient
from gubernator_tpu import daemon as jdaemon
from gubernator_tpu.core import config as jcfg
from gubernator_tpu.core import types as jt
from gubernator_tpu.discovery import dns as jdns
from gubernator_tpu.discovery import gossip as jgossip
from gubernator_tpu_torch import client as pclient
from gubernator_tpu_torch import daemon as pdaemon
from gubernator_tpu_torch.core import config as pcfg
from gubernator_tpu_torch.core import types as pt
from gubernator_tpu_torch.discovery import dns as pdns
from gubernator_tpu_torch.discovery import gossip as pgossip

NS = types.SimpleNamespace
JAX = NS(name="jax", pkg="gubernator_tpu", types=jt, cfg=jcfg, dns=jdns,
         gossip=jgossip, daemon=jdaemon, client=jclient,
         device=lambda: jcfg.DeviceConfig(num_slots=4096, ways=8,
                                          batch_size=128))
PORT = NS(name="port", pkg="gubernator_tpu_torch", types=pt, cfg=pcfg,
          dns=pdns, gossip=pgossip, daemon=pdaemon, client=pclient,
          device=lambda: pcfg.DeviceConfig(num_slots=4096, ways=8,
                                           batch_size=128, platform="cpu"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(coro):
    return asyncio.run(coro)


def rows(peers):
    return [(p.grpc_address, p.http_address, p.is_owner, p.data_center)
            for p in peers]


def both(fn):
    """fn(P) for the JAX package then the port; the two results must be
    equal.  Returns the port's."""
    want, got = fn(JAX), fn(PORT)
    assert got == want
    return got


async def until(cond, timeout=10.0, interval=0.05):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError("condition not met before timeout")
        await asyncio.sleep(interval)


def _mk_pool(P, port, seeds, updates, interval=0.1):
    return P.gossip.GossipPool(
        f"127.0.0.1:{port}",
        P.types.PeerInfo(grpc_address=f"127.0.0.1:{port - 1000}",
                         http_address=f"127.0.0.1:{port - 2000}",
                         data_center="dc-a"),
        lambda peers: updates.__setitem__(port, rows(peers)),
        seeds=seeds, gossip_interval_s=interval,
        suspect_after_s=1.0, reap_after_s=2.0,
    )


def _want(ports):
    return [(f"127.0.0.1:{p - 1000}", f"127.0.0.1:{p - 2000}", False, "dc-a")
            for p in sorted(ports)]


def test_gossip_join_and_leave():
    """Three pools converge on full membership; a graceful leave
    propagates.  Both packages publish the same lists."""
    ports = [19301, 19302, 19303]

    def go(P):
        async def scenario():
            updates = {}
            seeds = [f"127.0.0.1:{ports[0]}"]
            pools = [_mk_pool(P, p, [] if i == 0 else seeds, updates)
                     for i, p in enumerate(ports)]
            for p in pools:
                await p.start()
            await until(lambda: all(updates.get(p) == _want(ports)
                                    for p in ports))
            joined = dict(updates)
            await pools[2].close()
            await until(lambda: all(updates.get(p) == _want(ports[:2])
                                    for p in ports[:2]))
            left = {p: updates[p] for p in ports[:2]}
            for p in pools[:2]:
                await p.close()
            return joined, left

        return run(scenario())

    joined, left = both(go)
    assert joined == {p: _want(ports) for p in ports}
    assert left == {p: _want(ports[:2]) for p in ports[:2]}


def test_gossip_failure_detection():
    """A silently dead pool is suspected and reaped without a leave
    message, though the other two keep relaying its stale entry."""
    ports = [19311, 19312, 19313]

    def go(P):
        async def scenario():
            updates = {}
            pools = [_mk_pool(P, p, [] if i == 0
                              else [f"127.0.0.1:{ports[0]}"], updates)
                     for i, p in enumerate(ports)]
            for p in pools:
                await p.start()
            await until(lambda: all(updates.get(p) == _want(ports)
                                    for p in ports))
            pools[2]._task.cancel()
            pools[2]._transport.abort()
            await until(lambda: all(updates.get(p) == _want(ports[:2])
                                    for p in ports[:2]), timeout=20.0)
            out = ({p: updates[p] for p in ports[:2]},
                   [sorted(p.members()) for p in pools[:2]])
            for p in pools[:2]:
                await p.close()
            return out

        return run(scenario())

    published, members = both(go)
    assert published == {p: _want(ports[:2]) for p in ports[:2]}
    assert members == [[f"127.0.0.1:{p}" for p in ports[:2]]] * 2


class _Wire:
    """A datagram transport that records what the pool sends."""

    def __init__(self):
        self.sent = []

    def sendto(self, data, addr):
        self.sent.append((addr, json.loads(data.decode())))


def test_gossip_scripted_packets_match():
    """One pool per package, fed the same packets on the same frozen clock:
    joins through a relayed state, a ping's ack, a dead relayed entry, the
    refutation of its own death, a leave, three probes and a death verdict,
    a rejoin by a higher incarnation, the reaping of the dead entry and a
    new probe.
    After every step the published list, the live members, the incarnation
    and every packet sent are equal between the two packages."""
    A, B, C, D = (f"127.0.0.1:{p}" for p in (29401, 29402, 29403, 29404))

    def ent(P, addr, inc, dead=False):
        info = P.types.PeerInfo(grpc_address=addr.replace(":294", ":284"),
                                http_address=addr, data_center="dc-b")
        return {"info": asdict(info), "inc": inc, "dead": dead}

    def go(P):
        now = [100.0]
        mod = P.gossip
        saved = mod.time
        mod.time = NS(monotonic=lambda: now[0])
        try:
            published = []
            pool = mod.GossipPool(
                A, P.types.PeerInfo(grpc_address="127.0.0.1:28401",
                                    http_address=A, data_center="dc-b"),
                lambda peers: published.append(rows(peers)),
                seeds=[B], gossip_interval_s=0.1, suspect_after_s=1.0,
                reap_after_s=2.0)
            wire = _Wire()
            # start() without the socket and the gossip loop.
            pool._transport = wire
            pool._members[pool.self_addr] = mod._Member(
                pool.self_info, pool._incarnation)
            pool._publish()
            for seed in pool.seeds:
                pool._send_state(seed)

            def feed(msg):
                pool.datagram_received(json.dumps(msg).encode(), ("", 0))

            def state(sender, **members):
                feed({"type": "state", "from": sender, "members": members})

            trace = []

            def snap(step):
                trace.append((step, list(published), sorted(pool.members()),
                              pool._incarnation, list(wire.sent)))
                wire.sent.clear()

            snap("boot")
            state(B, **{B: ent(P, B, 1), C: ent(P, C, 1)})
            snap("join")
            feed({"type": "ping", "from": C})
            snap("ping")
            state(B, **{D: ent(P, D, 2, dead=True)})
            snap("dead relayed")
            state(B, **{A: ent(P, A, 1, dead=True)})
            pool._send_state(B)
            snap("refute")
            feed({"type": "leave", "addr": C})
            snap("leave")
            pool.datagram_received(b"\xff not json", ("", 0))  # ignored
            for dt in (1.5, 0.3, 0.3, 0.3):
                now[0] += dt
                pool._expire()
                snap(f"expire +{dt}")
            state(B, **{B: ent(P, B, 2)})
            snap("rejoin")
            now[0] += 0.5  # heard within the window: the probes reset
            pool._expire()
            snap("settle")
            now[0] += 5.0
            pool._expire()
            snap("reap")
            return trace, sorted(pool._members)
        finally:
            mod.time = saved

    trace, kept = both(go)
    steps = {step: (pub, members, inc) for step, pub, members, inc, _ in
             trace}
    me = ("127.0.0.1:28401", A, False, "dc-b")
    peer = lambda a: (a.replace(":294", ":284"), a, False, "dc-b")  # noqa: E731
    assert steps["join"][0][-1] == [me, peer(B), peer(C)]
    assert steps["refute"][2] == 2
    assert steps["leave"][0][-1] == [me, peer(B)]
    assert steps["expire +0.3"][0][-1] == [me]  # the third probe went unanswered
    assert steps["rejoin"][0][-1] == [me, peer(B)]
    assert kept == sorted([A, B])  # D was reaped, B is probed again
    pings = [a for _, _, _, _, sent in trace for a, m in sent
             if m["type"] == "ping"]
    assert pings == [("127.0.0.1", 29402)] * 4


def test_dns_pool_with_fake_resolver():
    """The DNS pool publishes one peer an A record at the configured
    ports, marks itself the owner, and republishes when the records
    change."""
    def go(P):
        records = {"guber.svc": ["10.4.0.2", "10.4.0.1"]}
        got = []

        async def fake_getaddrinfo(host, port, **kw):
            return [(socket.AF_INET, socket.SOCK_STREAM, 6, "", (ip, 0))
                    for ip in records[host]]

        async def scenario():
            asyncio.get_running_loop().getaddrinfo = fake_getaddrinfo
            pool = P.dns.DnsPool("guber.svc", lambda ps: got.append(rows(ps)),
                                 grpc_port=81, http_port=80,
                                 poll_interval_s=0.05,
                                 own_address="10.4.0.1:81",
                                 data_center="dc-c")
            await pool.start()
            await until(lambda: got)
            records["guber.svc"] = ["10.4.0.1", "10.4.0.3"]
            await until(lambda: got[-1][1][0] == "10.4.0.3:81")
            await asyncio.sleep(0.15)  # unchanged records publish nothing
            await pool.close()

        run(scenario())
        return got

    got = both(go)
    assert got == [
        [("10.4.0.1:81", "10.4.0.1:80", True, "dc-c"),
         ("10.4.0.2:81", "10.4.0.2:80", False, "dc-c")],
        [("10.4.0.1:81", "10.4.0.1:80", True, "dc-c"),
         ("10.4.0.3:81", "10.4.0.3:80", False, "dc-c")],
    ]


def test_dns_pool_resolves_localhost():
    def go(P):
        async def scenario():
            got = []
            pool = P.dns.DnsPool("localhost",
                                 lambda peers: got.append(rows(peers)),
                                 grpc_port=1051, http_port=1050,
                                 poll_interval_s=60.0,
                                 own_address="127.0.0.1:1051")
            await pool.start()
            await pool.close()
            return got

        return run(scenario())

    got = both(go)
    assert got and ("127.0.0.1:1051", "127.0.0.1:1050", True, "") in got[0]


def _distinct(updates):
    """The published lists with consecutive repeats folded: the k8s pool
    publishes on every poll, and how many polls land in a sleep varies."""
    out = []
    for u in updates:
        if not out or out[-1] != u:
            out.append(u)
    return out


def test_k8s_endpoints_churn(monkeypatch):
    def go(P):
        state = {"endpoints": [fakes._ep("10.0.0.1", "10.0.0.2")],
                 "pods": [], "calls": []}
        monkeypatch.setitem(sys.modules, "kubernetes",
                            fakes._fake_kubernetes(state))
        k8s = __import__(f"{P.pkg}.discovery.k8s", fromlist=["K8sPool"])
        updates = []

        async def scenario():
            pool = k8s.K8sPool(lambda ps: updates.append(rows(ps)),
                               namespace="guber", selector="app=gubernator",
                               pod_ip="10.0.0.2", poll_interval_s=0.02)
            await pool.start()
            state["endpoints"] = [fakes._ep("10.0.0.2", "10.0.0.3")]
            await until(lambda: updates[-1][-1][0] == "10.0.0.3:81")
            state["endpoints"] = None  # a failing list keeps the last set
            n = len(updates)
            await asyncio.sleep(0.06)
            assert updates[n:] == []
            await pool.close()

        run(scenario())
        return _distinct(updates), state["calls"][0]

    updates, first_call = both(go)
    assert first_call == ("endpoints", "guber", "app=gubernator")
    assert updates == [
        [("10.0.0.1:81", "10.0.0.1:80", False, ""),
         ("10.0.0.2:81", "10.0.0.2:80", True, "")],
        [("10.0.0.2:81", "10.0.0.2:80", True, ""),
         ("10.0.0.3:81", "10.0.0.3:80", False, "")],
    ]


def test_k8s_pods_mechanism_ready_filter(monkeypatch):
    def go(P):
        state = {"endpoints": [], "calls": [], "pods": [
            fakes._pod("10.1.0.1", ready=True),
            fakes._pod("10.1.0.2", ready=False),
            fakes._pod(None, ready=True),
        ]}
        monkeypatch.setitem(sys.modules, "kubernetes",
                            fakes._fake_kubernetes(state))
        k8s = __import__(f"{P.pkg}.discovery.k8s", fromlist=["K8sPool"])
        updates = []

        async def scenario():
            pool = k8s.K8sPool(lambda ps: updates.append(rows(ps)),
                               mechanism="pods", poll_interval_s=5.0)
            await pool.start()
            await pool.close()

        run(scenario())
        return updates, state["calls"]

    updates, calls = both(go)
    assert updates == [[("10.1.0.1:81", "10.1.0.1:80", False, "")]]
    assert calls[0][0] == "pods"


def test_etcd_register_watch_churn_teardown(monkeypatch):
    def go(P):
        fake = fakes._FakeEtcd()
        monkeypatch.setitem(sys.modules, "etcd3", fakes._fake_etcd3(fake))
        etcd_mod = __import__(f"{P.pkg}.discovery.etcd", fromlist=["EtcdPool"])
        updates = []
        me = P.types.PeerInfo(grpc_address="10.2.0.1:81",
                              http_address="10.2.0.1:80", data_center="dc-e")
        key = "/gubernator/peers/10.2.0.1:81"

        async def scenario():
            pool = etcd_mod.EtcdPool(lambda ps: updates.append(rows(ps)), me,
                                     endpoints="etcd.example:2379")
            await pool.start()
            registered = (dict(fake.kv), fake.leases[0].revoked)
            fake.remote_put("/gubernator/peers/10.2.0.2:81",
                            P.types.PeerInfo(grpc_address="10.2.0.2:81",
                                             data_center="dc-w"))
            fake.delete("/gubernator/peers/10.2.0.2:81")
            await pool.close()
            return registered

        registered = run(scenario())
        return (updates, registered, fake.cancelled_watches,
                key in fake.kv, fake.leases[0].revoked)

    updates, registered, cancelled, kept, revoked = both(go)
    kv, revoked_at_start = registered
    assert list(kv) == ["/gubernator/peers/10.2.0.1:81"]
    assert not revoked_at_start
    mine = ("10.2.0.1:81", "10.2.0.1:80", True, "dc-e")
    # close() deletes its own key before it cancels the watch, so the
    # last list is empty.
    assert _distinct(updates) == [
        [mine], [mine, ("10.2.0.2:81", "", False, "dc-w")], [mine], []]
    assert cancelled == [1] and not kept and revoked


def test_etcd_lease_expiry_reregisters(monkeypatch):
    def go(P):
        fake = fakes._FakeEtcd()
        monkeypatch.setitem(sys.modules, "etcd3", fakes._fake_etcd3(fake))
        etcd_mod = __import__(f"{P.pkg}.discovery.etcd", fromlist=["EtcdPool"])
        monkeypatch.setattr(etcd_mod, "LEASE_TTL_S", 0.15)

        async def scenario():
            pool = etcd_mod.EtcdPool(
                lambda ps: None, P.types.PeerInfo(grpc_address="10.3.0.1:81"))
            await pool.start()
            before = (fake.puts, len(fake.leases))
            fake.refresh_ttl = 0  # the lease was lost server-side
            await until(lambda: fake.puts > before[0]
                        and len(fake.leases) > before[1], timeout=5.0)
            fake.refresh_ttl = 30
            await pool.close()
            return before, sorted(fake.kv)

        return run(scenario())

    before, kv = both(go)
    assert before == (1, 1)
    assert kv == []  # close() deleted the re-registered key


def _free_ports(n):
    """n gRPC ports whose gossip ports (+1000) are free too."""
    out = []
    while len(out) < n:
        socks = []
        try:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            port = s.getsockname()[1]
            if port + 1000 > 65535:
                continue
            g = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            g.bind(("127.0.0.1", port + 1000))
            socks.append(g)
            out.append(port)
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    return out


def test_gossip_daemons_from_env_converge_and_route(monkeypatch):
    """Three daemons per package configured by GUBER_PEER_DISCOVERY_TYPE=
    gossip (gossip on gRPC port + 1000, seeded with the first node's) find
    each other with no static peer list and route checks to every owner.
    Both packages run on the same ports, so the ring places every key on
    the same node, and the answers must be equal."""
    ports = _free_ports(3)
    monkeypatch.setenv("GUBER_PEER_DISCOVERY_TYPE", "gossip")
    monkeypatch.setenv("GUBER_TPU_PLATFORM", "cpu")

    def confs(P):
        out = []
        for i, p in enumerate(ports):
            monkeypatch.setenv("GUBER_GRPC_ADDRESS", f"127.0.0.1:{p}")
            monkeypatch.setenv("GUBER_HTTP_ADDRESS", "127.0.0.1:0")
            monkeypatch.setenv("GUBER_ADVERTISE_ADDRESS", f"127.0.0.1:{p}")
            monkeypatch.setenv("GUBER_GOSSIP_ADDRESS",
                               f"127.0.0.1:{p + 1000}")
            monkeypatch.setenv(
                "GUBER_GOSSIP_SEEDS",
                "" if i == 0 else f"127.0.0.1:{ports[0] + 1000}")
            out.append(P.cfg.setup_daemon_config())
        return out

    def go(P):
        cs = confs(P)
        assert all(c.peer_discovery_type == "gossip" for c in cs)
        assert cs[1].gossip_seeds == [f"127.0.0.1:{ports[0] + 1000}"]

        async def scenario():
            daemons = []
            try:
                for conf in cs:
                    conf.device = P.device()
                    d = P.daemon.Daemon(conf)
                    await d.start()
                    daemons.append(d)
                await P.daemon.wait_for_connect(
                    [d.grpc_address for d in daemons])
                await until(lambda: all(d.service.local_picker.size() == 3
                                        for d in daemons), timeout=30.0)
                cl = P.client.AsyncV1Client(daemons[0].grpc_address)
                try:
                    resps = await cl.get_rate_limits([
                        P.types.RateLimitReq(name="g", unique_key=f"k{i}",
                                             hits=1, limit=10,
                                             duration=60_000)
                        for i in range(48)])
                finally:
                    await cl.close()
                return [(r.error, r.remaining, r.limit,
                         (r.metadata or {}).get("owner", "local"))
                        for r in resps]
            finally:
                for d in daemons:
                    await d.close()

        return run(scenario())

    answers = both(go)
    assert all(e == "" and rem == 9 and lim == 10
               for e, rem, lim, _ in answers)
    assert {o for *_, o in answers} == (
        {f"127.0.0.1:{p}" for p in ports[1:]} | {"local"})
