"""The port's chaos plane (gubernator_tpu_torch/testing/chaos.py, wired
through the daemon and every PeerClient) and the resilience paths it
drives, against the JAX package's, on the CPU.

The breaker schedules of tests/test_chaos.py walk both packages'
breakers on one fake clock and rng; a seeded plan decides the same faults
in both and survives a JSON round trip (and a daemon's GUBER_CHAOS_PLAN
load); the degraded modes answer alike; and a partition on a port
cluster holds the local_shadow bound with exact ledger values."""
from __future__ import annotations

import asyncio
import dataclasses
import json
import random

import pytest
import torch

from gubernator_tpu.core import config as jcfg
from gubernator_tpu.core import types as jt
from gubernator_tpu.net import breaker as jbrk
from gubernator_tpu.net import peer_client as jpc
from gubernator_tpu.runtime.service import Service as JaxService
from gubernator_tpu.testing import chaos as jchaos
from gubernator_tpu_torch.client import V1Client
from gubernator_tpu_torch.core import config as pcfg
from gubernator_tpu_torch.core import types as pt
from gubernator_tpu_torch.daemon import Daemon
from gubernator_tpu_torch.net import breaker as pbrk
from gubernator_tpu_torch.net import peer_client as ppc
from gubernator_tpu_torch.runtime.service import SHADOW_SUFFIX, Service
from gubernator_tpu_torch.testing import chaos as pchaos
from gubernator_tpu_torch.testing.cluster import Cluster

SEED = 1337
DURATION = 600_000
CPU = dict(num_slots=1024, ways=8, batch_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def walk_schedule(brk, cfg_kw, t):
    """The closed -> open -> half-open -> closed walk of
    tests/test_chaos.py; returns every observable along the way."""
    seen = []
    b = brk.CircuitBreaker(
        brk.CircuitConfig(**cfg_kw), clock=lambda: t[0],
        rng=random.Random(SEED),
        on_transition=lambda o, n: seen.append((o.name, n.name)))

    def snap():
        seen.append((b.state.name, b.trips, b.would_allow(),
                     round(b.open_until - b.opened_at, 9)))

    b.record_failure(), b.record_failure(), b.record_success()
    for _ in range(3):
        b.record_failure()
    snap()
    t[0] = 0.51
    seen.append((b.allow(), b.allow()))
    b.record_failure()
    snap()
    t[0] = b.open_until + 0.01
    seen.append(b.allow())
    b.record_success()
    for _ in range(3):
        b.record_failure()
    snap()
    return seen


def abandoned_probe(brk, cfg_kw, t):
    seen = []
    b = brk.CircuitBreaker(brk.CircuitConfig(**cfg_kw), clock=lambda: t[0],
                           rng=random.Random(SEED))
    b.record_failure()
    for now in (0.6, 5.5, 5.7):
        t[0] = now
        seen.append((b.would_allow(), b.allow(), b.state.name, b.trips))
    t[0] = b.open_until + 0.01
    seen.append((b.allow(), b.fast_fail()))
    b.record_success()
    seen.append(b.state.name)
    return seen


def backoff_jitter(brk, cfg_kw, t):
    b = brk.CircuitBreaker(brk.CircuitConfig(**cfg_kw), clock=lambda: t[0],
                           rng=random.Random(SEED))
    return [b.backoff_s(streak) for streak in range(1, 8) for _ in range(8)]


BREAKER_CASES = {
    "walk": (walk_schedule, dict(failure_threshold=3, base_backoff_s=0.5,
                                 max_backoff_s=4.0, jitter=0.0,
                                 half_open_probes=1)),
    "abandoned_probe": (abandoned_probe, dict(
        failure_threshold=1, base_backoff_s=0.5, max_backoff_s=4.0,
        jitter=0.0, half_open_probes=1, probe_timeout_s=5.0)),
    "backoff_jitter": (backoff_jitter, dict(
        failure_threshold=1, base_backoff_s=0.2, max_backoff_s=1.5,
        jitter=0.25)),
}


@pytest.mark.parametrize("name", sorted(BREAKER_CASES))
def test_breaker_schedules_equal(name):
    fn, kw = BREAKER_CASES[name]

    class P:  # the port's breaker module with the port's config class
        CircuitBreaker = pbrk.CircuitBreaker
        CircuitConfig = pcfg.CircuitConfig

    class J:
        CircuitBreaker = jbrk.CircuitBreaker
        CircuitConfig = jcfg.CircuitConfig

    got, want = fn(P, kw, [0.0]), fn(J, kw, [0.0])
    assert got == want
    if name == "walk":
        assert got[-1][:2] == ("OPEN", 3) and got[-1][3] == 0.5
    elif name == "abandoned_probe":
        assert got[2][2:] == ("OPEN", 2) and got[-1] == "CLOSED"
    else:
        for i, v in enumerate(got):
            base = min(0.2 * 2 ** (i // 8), 1.5)
            assert base * 0.75 <= v <= base * 1.25


def test_seeded_plan_equal_and_serializable(tmp_path):
    """One plan dict decides the same faults in both packages, survives a
    JSON round trip, and loads through a daemon's GUBER_CHAOS_PLAN path
    (with GUBER_CHAOS_SEED overriding the seed) as the JAX loader does."""
    plan = {"seed": 99, "rules": [
        {"op": "error", "probability": 0.5,
         "message": "injected: failed to connect"},
        {"op": "delay", "probability": 0.2, "delay_s": 0.001},
        {"op": "error", "probability": 1.0, "method": "Lease",
         "max_count": 3}]}

    async def drive(inj):
        out = []
        for i in range(200):
            try:
                await inj.on_client("a:1", "b:2",
                                    "Lease" if i % 4 == 0 else "M")
                out.append("ok")
            except Exception as e:  # noqa: BLE001 — compared below
                out.append(str(e.code()))
        return out, dict(inj.injected), inj.failure_fraction()

    got = asyncio.run(drive(pchaos.ChaosInjector(
        pchaos.ChaosPlan.from_dict(plan))))
    want = asyncio.run(drive(jchaos.ChaosInjector(
        jchaos.ChaosPlan.from_dict(plan))))
    assert got == want and 0.3 < got[2] < 0.7
    assert "StatusCode.UNAVAILABLE" in got[0]
    trip = pchaos.ChaosPlan.from_dict(json.loads(json.dumps(
        dataclasses.asdict(pchaos.ChaosPlan.from_dict(plan)))))
    assert dataclasses.asdict(trip) == dataclasses.asdict(
        jchaos.ChaosPlan.from_dict(plan))
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan))
    d = Daemon(pcfg.DaemonConfig(
        device=pcfg.DeviceConfig(platform="cpu", **CPU),
        chaos_plan=str(path), chaos_seed=7))
    assert dataclasses.asdict(d.chaos.plan) == dataclasses.asdict(
        jchaos.load_plan(str(path), seed_override=7))
    assert d.chaos.plan.seed == 7


@pytest.mark.parametrize("mode,limit", [
    ("fail_closed", 10), ("fail_open", 10), ("error", 10),
    ("local_shadow", 0)])
def test_degraded_modes_equal(mode, limit, frozen_clock):
    t0 = frozen_clock.now_ns()

    def run(port):
        mod, T, pc = (pcfg, pt, ppc) if port else (jcfg, jt, jpc)
        dev = (mod.DeviceConfig(platform="cpu", **CPU) if port
               else mod.DeviceConfig(**CPU))
        svc = (Service if port else JaxService)(
            mod.Config(device=dev, degraded_mode=mode), clock=frozen_clock)

        async def go():
            try:
                peer = pc.PeerClient(T.PeerInfo(grpc_address="127.0.0.1:1"))
                req = T.RateLimitReq(name="deg", unique_key="k", hits=1,
                                     limit=limit, duration=DURATION)
                resp = await svc._degraded_response(
                    req, req.hash_key(), peer, pc.PeerNotReadyError("gone"))
                await peer.shutdown()
                return (int(resp.status), resp.limit, resp.remaining,
                        resp.reset_time, resp.error,
                        dict(resp.metadata or {}), dict(svc._shadow),
                        svc.backend.get_cache_item("deg_k" + SHADOW_SUFFIX))
            finally:
                await svc.close()

        return asyncio.run(go())

    got = run(True)
    frozen_clock.freeze(t0)
    assert got == run(False)
    if mode == "fail_closed":
        assert got[:3] == (int(pt.Status.OVER_LIMIT), 10, 0)
    elif mode == "fail_open":
        assert got[:3] == (int(pt.Status.UNDER_LIMIT), 10, 9)
    elif mode == "error":
        assert "not connected" in got[4]
    else:
        assert got[:3] == (int(pt.Status.OVER_LIMIT), 0, 0)
        assert got[6] == {} and got[7] is None


SHADOW_FRACTION = 0.25


def test_partition_bound_exact_on_port_cluster():
    """The owner partitioned from the other two daemons by a seeded plan:
    it admits exactly its limit, each partitioned daemon exactly its
    local_shadow slot (fraction x limit), so the cluster admits exactly
    limit + peers x fraction x limit; after the heal the shadows drop and
    the owner's row is the only state."""
    inj = pchaos.ChaosInjector(pchaos.ChaosPlan(seed=SEED))
    c = Cluster.start_with(
        ["", "", ""], device=pcfg.DeviceConfig(platform="cpu", **CPU),
        conf_template=pcfg.DaemonConfig(
            circuit=pcfg.CircuitConfig(failure_threshold=3,
                                       base_backoff_s=0.1,
                                       max_backoff_s=1.0, jitter=0.2),
            degraded_mode="local_shadow", shadow_fraction=SHADOW_FRACTION,
            chaos=inj))
    try:
        limit, key = 40, "partme"
        hash_key = f"part_{key}"
        owner = c.owner_daemon_of(hash_key)
        others = [d for d in c.daemons if d is not owner]
        assert all(d.service.chaos is not None for d in c.daemons)
        inj.partition({owner.grpc_address},
                      {d.grpc_address for d in others})
        req = pt.RateLimitReq(name="part", unique_key=key, hits=1,
                              limit=limit, duration=DURATION)

        def drive(d, n, r=req):
            cl = V1Client(d.grpc_address)
            try:
                return [cl.get_rate_limits([r], timeout=30)[0]
                        for _ in range(n)]
            finally:
                cl.close()

        def admitted(rs):
            return sum(r.error == "" and r.status == pt.Status.UNDER_LIMIT
                       for r in rs)

        shadow = int(limit * SHADOW_FRACTION)
        assert admitted(drive(owner, 50)) == limit
        for d in others:
            rs = drive(d, 30)
            assert admitted(rs) == shadow
            assert all(r.metadata["degraded"] == "local_shadow"
                       and r.metadata["owner"] == owner.grpc_address
                       for r in rs)
            item = d.service.backend.get_cache_item(hash_key + SHADOW_SUFFIX)
            assert item.limit == shadow and int(item.remaining) == 0
        assert inj.failure_fraction() > 0
        inj.heal()
        probe = dataclasses.replace(req, hits=0)
        for d in others:
            for _ in range(100):
                r = drive(d, 1, probe)[0]
                if "degraded" not in (r.metadata or {}):
                    break
            assert r.error == "" and r.remaining == 0
            c.run(asyncio.sleep(0.2))
            assert not d.service._shadow.get(owner.grpc_address)
            assert d.service.backend.get_cache_item(
                hash_key + SHADOW_SUFFIX) is None
        assert int(owner.service.backend.get_cache_item(
            hash_key).remaining) == 0
    finally:
        c.stop()
