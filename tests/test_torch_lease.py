"""The port's owner-side admission leases (gubernator_tpu_torch/runtime/
lease.py, the service's Lease/Reconcile RPCs) and its client SDK
(gubernator_tpu_torch/client.py) against the JAX package's, on the CPU.

The grant, refusal, expiry-sweep, renew/release, shedding-refusal and
remap scenarios of tests/test_lease.py run on a bare Service of each
package from one frozen instant: the LeaseGrant lists and the carve and
authoritative rows are equal.  A port cluster holds the exact
over-admission bound (150 == 100 x (1 + 2 x 0.25)) and LeasedClient's
zero-RPC steady state; FastV1Client's native codec matches python
protobuf on the wire."""
from __future__ import annotations

import asyncio
import dataclasses

import pytest
import torch

from gubernator_tpu.core import config as jcfg
from gubernator_tpu.core import types as jt
from gubernator_tpu.runtime.service import Service as JaxService
from gubernator_tpu_torch import native
from gubernator_tpu_torch.client import FastV1Client, LeasedClient, V1Client
from gubernator_tpu_torch.core import config as pcfg
from gubernator_tpu_torch.core import types as pt
from gubernator_tpu_torch.net import grpc_api
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.runtime.lease import LEASE_SUFFIX
from gubernator_tpu_torch.runtime.service import Service
from gubernator_tpu_torch.testing.cluster import Cluster
from test_lease import until_pass

LIMIT = 100
DURATION = 60_000
CPU = dict(num_slots=2048, ways=8, batch_size=64)
ME, OTHER, THIRD = "10.0.0.1:1051", "10.0.0.2:1051", "10.0.0.3:1051"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def row(svc, key):
    it = svc.backend.get_cache_item(key)
    return None if it is None else (
        int(it.algorithm), it.limit, int(it.remaining), it.expire_at)


def grants(gs):
    return [dataclasses.astuple(g) for g in gs]


async def scn_grant_refusal(s, T, clock):
    lm = s.leases

    def req(**kw):
        kw.setdefault("key", "k")
        return T.RateLimitReq(name="lease", unique_key=kw.pop("key"),
                              hits=1, limit=kw.pop("limit", LIMIT),
                              duration=DURATION, **kw)

    out = []
    for cid in ("a", "b", "c", "a"):
        out.append(grants(await lm.grant(cid, [req()])))
    for bad in (req(behavior=T.Behavior.GLOBAL),
                req(behavior=T.Behavior.RESET_REMAINING),
                req(behavior=T.Behavior.DURATION_IS_GREGORIAN),
                req(limit=0), req(key="")):
        out.append(grants(await lm.grant("z", [bad])))
    return out


async def scn_expiry_sweep(s, T, clock):
    lm = s.leases
    req = T.RateLimitReq(name="lease", unique_key="k", hits=1, limit=LIMIT,
                         duration=DURATION)
    out = [grants(await lm.grant("a", [req]))]
    out.append(grants(await lm.reconcile("a", [T.ReconcileItem(
        request=T.RateLimitReq(name="lease", unique_key="k", hits=7,
                               limit=LIMIT, duration=DURATION))])))
    for _ in range(200):
        if row(s, "lease_k") is not None:
            break
        await asyncio.sleep(0.01)
    out.append((row(s, "lease_k"), lm.reconciled_hits))
    clock.advance(3000)
    out.append((await lm.sweep_apply(), lm.revocations,
                row(s, "lease_k" + LEASE_SUFFIX)))
    out.append(grants(await lm.grant("a", [req])))
    return out


async def scn_renew_release(s, T, clock):
    lm = s.leases

    def req(hits):
        return T.RateLimitReq(name="lease", unique_key="k", hits=hits,
                              limit=LIMIT, duration=DURATION)

    out = [grants(await lm.grant("a", [req(1)])),
           grants(await lm.grant("b", [req(1)]))]
    out.append(grants(await lm.reconcile(
        "a", [T.ReconcileItem(request=req(25), renew=True)])))
    out.append(grants(await lm.reconcile(
        "b", [T.ReconcileItem(request=req(0), release=True)])))
    out.append(lm.revocations)
    out.append(grants(await lm.reconcile(
        "a", [T.ReconcileItem(request=req(0), release=True)])))
    out.append(row(s, "lease_k" + LEASE_SUFFIX))
    return out


async def scn_shedding(s, T, clock):
    s.shed_level = lambda: 1
    req = T.RateLimitReq(name="lease", unique_key="k", hits=1, limit=LIMIT,
                         duration=DURATION)
    return [grants(await s.leases.grant("a", [req])),
            grants(await s.lease("a", [req]))]


async def scn_remap(s, T, clock):
    """A demoted owner stops honoring grants: the remap revokes unowned
    holders and drops their carve slots; owned keys keep theirs."""
    from gubernator_tpu_torch.net.replicated_hash import (
        ReplicatedConsistentHash,
        xx_64,
    )

    class _P:
        def __init__(self, addr):
            self.grpc_address = addr

        def info(self):
            return self

    def owner(addrs, key):
        ring = ReplicatedConsistentHash(xx_64)
        for a in addrs:
            ring.add(_P(a))
        return ring.get(key).info().grpc_address

    key = next(f"m{i}" for i in range(2000)
               if owner((ME, OTHER), f"lease_m{i}") == ME
               and owner((ME, OTHER, THIRD), f"lease_m{i}") != ME)
    kept = next(f"m{i}" for i in range(2000)
                if owner((ME, OTHER, THIRD), f"lease_m{i}") == ME)
    lm = s.leases

    def req(k):
        return T.RateLimitReq(name="lease", unique_key=k, hits=1,
                              limit=LIMIT, duration=DURATION)

    await s.set_peers([T.PeerInfo(grpc_address=ME, is_owner=True),
                       T.PeerInfo(grpc_address=OTHER)])
    out = [grants(await lm.grant("h", [req(key)])),
           grants(await lm.grant("h", [req(kept)]))]
    await s.set_peers([T.PeerInfo(grpc_address=a, is_owner=(a == ME))
                       for a in (ME, OTHER, THIRD)])
    out.append(grants(await lm.grant("h", [req(key)])))
    out.append(await lm.drop_unowned())
    out += [row(s, f"lease_{k}" + LEASE_SUFFIX) for k in (key, kept)]
    with lm._lock:
        out.append(sorted(lm._keys))
    return out


SCENARIOS = {
    "grant_refusal": scn_grant_refusal,
    "expiry_sweep": scn_expiry_sweep,
    "renew_release": scn_renew_release,
    "shedding": scn_shedding,
    "remap": scn_remap,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_lease_manager_matches_jax(name, frozen_clock):
    t0 = frozen_clock.now_ns()
    lease = dict(fraction=0.25, ttl_ms=2000, max_holders=2,
                 reconcile_ms=200)

    def run(port):
        mod, T = (pcfg, pt) if port else (jcfg, jt)
        dev = (mod.DeviceConfig(platform="cpu", **CPU) if port
               else mod.DeviceConfig(**CPU))
        svc = (Service if port else JaxService)(mod.Config(
            device=dev, lease=mod.LeaseConfig(**lease),
            reshard=mod.ReshardConfig(enabled=False)), clock=frozen_clock)

        async def go():
            await svc.start()
            try:
                out = await SCENARIOS[name](svc, T, frozen_clock)
                return out, row(svc, "lease_k" + LEASE_SUFFIX), row(
                    svc, "lease_k")
            finally:
                await svc.close()

        return asyncio.run(go())

    got = run(True)
    frozen_clock.freeze(t0)
    want = run(False)
    assert got == want
    out = got[0]
    if name == "grant_refusal":
        # allowance 25 twice, then the holder gate, then the spent budget;
        # the carve slot (limit 2 x 25) is spent, the real row untouched.
        assert [g[0][1] for g in out[:4]] == [25, 25, 0, 0]
        assert "max concurrent holders" in out[2][0][-1]
        assert "exhausted" in out[3][0][-1]
        assert all(g[0][1] == 0 and g[0][-1] for g in out[4:])
        assert got[1][1:3] == (50, 0) and got[2] is None
    elif name == "expiry_sweep":
        assert out[2] == ((0, LIMIT, LIMIT - 7, out[2][0][3]), 7)
        assert out[3] == (1, 1, None) and out[4][0][1] == 25
    elif name == "renew_release":
        assert "exhausted" in out[2][0][-1] and out[3][0][-1] == "released"
        assert out[4] == 1 and out[6] is None
    elif name == "shedding":
        assert all("pressure" in g[0][-1] for g in out)
    else:
        assert out[0][0][1] == 25 and "not the owner" in out[2][0][-1]
        assert out[4] is None and out[5] is not None


def test_lease_env_parse_equal(monkeypatch):
    monkeypatch.delenv("GUBER_LEASE_ENABLED", raising=False)
    assert pcfg.lease_config_from_env().enabled
    assert (dataclasses.asdict(pcfg.lease_config_from_env())
            == dataclasses.asdict(jcfg.lease_config_from_env()))
    for k, v in {"GUBER_LEASE_FRACTION": "0.5", "GUBER_LEASE_TTL": "5s",
                 "GUBER_LEASE_RECONCILE": "1s",
                 "GUBER_LEASE_MAX_HOLDERS": "3"}.items():
        monkeypatch.setenv(k, v)
    got = dataclasses.asdict(pcfg.lease_config_from_env())
    assert got == dataclasses.asdict(jcfg.lease_config_from_env())
    assert (got["fraction"], got["ttl_ms"], got["max_holders"]) == (
        0.5, 5000, 3)
    monkeypatch.setenv("GUBER_LEASE_TTL", "100ms")
    for mod in (pcfg, jcfg):
        with pytest.raises(ValueError, match="GUBER_LEASE_TTL"):
            mod.lease_config_from_env()


# ---------------------------------------------------------------------
# a port cluster
# ---------------------------------------------------------------------

FRACTION = 0.25
HOLDERS = 2
BOUND_LEASE = dict(fraction=FRACTION, ttl_ms=60_000, max_holders=HOLDERS,
                   reconcile_ms=60_000, low_water=0.0)


@pytest.fixture(scope="module")
def lease_cluster():
    c = Cluster.start_with(
        ["", "", ""],
        device=pcfg.DeviceConfig(platform="cpu", **CPU),
        conf_template=pcfg.DaemonConfig(
            lease=pcfg.LeaseConfig(**BOUND_LEASE)))
    yield c
    c.stop()


def _req(key, limit=LIMIT):
    return pt.RateLimitReq(name="lease", unique_key=key, hits=1,
                           limit=limit, duration=DURATION)


def test_over_admission_bound_exact_on_port_cluster(lease_cluster):
    """Two LeasedClients and a V1Client saturate one key through daemon
    0 with reconcile quiesced: exactly 100 x (1 + 2 x 0.25) admitted,
    every path then answers OVER_LIMIT, and the owner's row and carve
    slot both read remaining 0."""
    c = lease_cluster
    addr = c.daemons[0].grpc_address
    cfg = pcfg.LeaseConfig(**BOUND_LEASE)
    clients = [LeasedClient(addr, lease=cfg, client_id=f"h{i}")
               for i in range(HOLDERS)]
    direct = V1Client(addr)
    admitted = 0
    try:
        for lc in clients:
            r = lc.get_rate_limits([_req("bound")])[0]
            admitted += r.error == "" and r.status == pt.Status.UNDER_LIMIT

        def granted():
            for lc in clients:
                assert any(v.allowance_left > 0
                           for v in lc.table._leases.values()), lc.stats()
        until_pass(granted, timeout=10.0)
        for lc in clients:
            for _ in range(int(LIMIT * FRACTION) + 10):
                r = lc.get_rate_limits([_req("bound")])[0]
                admitted += (r.error == ""
                             and r.status == pt.Status.UNDER_LIMIT)
        for _ in range(LIMIT + 20):
            r = direct.get_rate_limits([_req("bound")])[0]
            admitted += r.error == "" and r.status == pt.Status.UNDER_LIMIT
        assert admitted == int(LIMIT * (1 + HOLDERS * FRACTION)) == 150
        for cl in [direct] + clients:
            assert cl.get_rate_limits([_req("bound")])[0].status == (
                pt.Status.OVER_LIMIT)
        owner = c.owner_daemon_of("lease_bound")
        be = owner.service.backend
        assert int(be.get_cache_item("lease_bound").remaining) == 0
        slot = be.get_cache_item("lease_bound" + LEASE_SUFFIX)
        assert slot.limit == 50 and int(slot.remaining) == 0
    finally:
        for lc in clients:
            lc.close()
        direct.close()


def test_leased_client_zero_rpc_steady_state(lease_cluster):
    """Steady single-key load burns locally: at least 10x fewer RPCs than
    checks, and after close the owner's row holds every burned hit."""
    c = lease_cluster
    cfg = pcfg.LeaseConfig(fraction=0.25, ttl_ms=60_000, max_holders=2,
                           reconcile_ms=500, low_water=0.25)
    lc = LeasedClient(c.daemons[0].grpc_address, lease=cfg,
                      client_id="steady")
    big = _req("steady", limit=1_000_000)
    n = 400
    try:
        lc.get_rate_limits([big])
        until_pass(lambda: assert_granted(lc), timeout=10.0)
        for _ in range(n):
            lc.get_rate_limits([big])
        stats = lc.stats()
        assert stats["local_admitted"] >= n
        assert stats["rpcs"] * 10 <= stats["checks"], stats
    finally:
        lc.close()
    owner = c.owner_daemon_of("lease_steady")

    def reconciled():
        it = owner.service.backend.get_cache_item("lease_steady")
        assert 1_000_000 - int(it.remaining) == n + 1
    until_pass(reconciled, timeout=15.0)


def assert_granted(lc):
    assert any(v.allowance_left > 0 for v in lc.table._leases.values())


def test_fast_client_wire_parity(lease_cluster):
    """FastV1Client's native codec encodes what python protobuf encodes,
    and answers as V1Client does (validation-error lanes included)."""
    if not native.available():
        pytest.skip("native library not built")
    reqs = [
        pt.RateLimitReq(name="n", unique_key="k", hits=-5, limit=2**45,
                        duration=0, behavior=pt.Behavior.GLOBAL, burst=7),
        pt.RateLimitReq(),
        pt.RateLimitReq(name="ütf-8", unique_key="ключ", hits=1, limit=1,
                        duration=1),
    ]
    assert native.encode_reqs(reqs) == pb.GetRateLimitsReq(
        requests=[grpc_api.req_to_pb(r) for r in reqs]).SerializeToString()
    addr = lease_cluster.daemons[0].grpc_address
    fc, vc = FastV1Client(addr), V1Client(addr)
    try:
        assert fc.codec == "native"
        batch = [_req(f"fp{i}", limit=50) for i in range(8)] + [
            pt.RateLimitReq(name="", unique_key="x", hits=1, limit=1,
                            duration=1000),
            pt.RateLimitReq(name="y", unique_key="", hits=1, limit=1,
                            duration=1000)]
        a, b = fc.get_rate_limits(list(batch)), vc.get_rate_limits(batch)
        assert len(a) == len(b) == 10
        for ra, rb in zip(a, b):
            assert (ra.status, ra.limit, ra.error) == (
                rb.status, rb.limit, rb.error)
            assert ra.remaining == rb.remaining + 1 or ra.error
    finally:
        fc.close()
        vc.close()
