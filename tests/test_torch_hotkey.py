"""The port's hot-key survival plane (gubernator_tpu_torch/runtime/hotkey.py
and the service's mirror and shed paths) against the JAX package's, on the
CPU.

The tracker runs beside the JAX tracker and the `_HysteresisOracle` of
tests/test_hotkey.py on seeded streams, on a manual clock: the hot sets,
counters and `debug_vars()` are equal after every window.  The env parse,
the next-arc mirror sets and the shed levels are compared on both
packages; one port cluster drives the whole lifecycle (promotion under
measured owner pressure, mirror serving, the exact over-admission bound,
collapse) through K1's plain version."""
from __future__ import annotations

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from gubernator_tpu.core import config as jcfg
from gubernator_tpu.core import types as jt
from gubernator_tpu.net.replicated_hash import ReplicatedConsistentHash as JRing
from gubernator_tpu.runtime import hotkey as jhot
from gubernator_tpu.runtime.service import Service as JaxService
from gubernator_tpu_torch.client import V1Client
from gubernator_tpu_torch.core import config as pcfg
from gubernator_tpu_torch.core import types as pt
from gubernator_tpu_torch.net.replicated_hash import (
    ReplicatedConsistentHash as PRing,
)
from gubernator_tpu_torch.runtime import hotkey as phot
from gubernator_tpu_torch.runtime.service import Service
from gubernator_tpu_torch.testing.cluster import Cluster
from test_hotkey import _HysteresisOracle, until_pass

CPU = dict(num_slots=4096, ways=8, batch_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# the tracker, window for window
# ---------------------------------------------------------------------

def _hover(rng):
    keys = [jhot.fp64(int(h)) for h in rng.integers(1, 2**62, size=40)]
    return [{k: int(rng.integers(70, 131)) for k in keys}
            for _ in range(60)]


STREAMS = {
    # threshold, promote, demote, max_hot, pressure, stream(rng)
    "hover": (100.0, 2, 3, 1024, 1.0, _hover),
    "hover_quick": (100.0, 1, 2, 1024, 1.0, _hover),
    "alternating": (100.0, 2, 2, 8, 1.0, lambda rng: [
        {jhot.fp64(0xDEADBEEF): 200 if w % 2 == 0 else 10}
        for w in range(20)]),
    "sustained_then_idle": (100.0, 3, 2, 8, 1.0, lambda rng: (
        [{jhot.fp64(42): 500}] * 5 + [{jhot.fp64(42): 1}] * 3
        + [{}] * 4)),
    "no_pressure": (10.0, 1, 1, 8, 0.0, lambda rng: (
        [{jhot.fp64(777): 10_000_000}] * 5)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_tracker_matches_jax_and_oracle_every_window(name):
    thr, pw, dw, max_hot, ratio, make = STREAMS[name]
    stream = make(np.random.default_rng(1337))

    def cfg(mod):
        return mod.HotKeyConfig(threshold=thr, window_s=1.0,
                                promote_windows=pw, demote_windows=dw,
                                max_hot=max_hot)

    clock = [0.0]
    port = phot.HotKeyTracker(cfg(pcfg), time_fn=lambda: clock[0])
    jax = jhot.HotKeyTracker(cfg(jcfg), time_fn=lambda: clock[0])
    for tr in (port, jax):
        tr.pressure_fn = lambda fp: ratio
    oracle = _HysteresisOracle(cfg(jcfg), lambda fp: ratio)
    for counts in stream:
        if counts:
            fps = np.fromiter(counts, dtype=np.int64, count=len(counts))
            hits = np.fromiter(counts.values(), dtype=np.int64,
                               count=len(counts))
            port.observe(fps, hits)
            jax.observe(fps, hits)
        clock[0] += 1.0
        port.poll()
        jax.poll()
        oracle.window(counts)
        assert set(port.hot_set) == set(jax.hot_set) == oracle.hot
        assert (port.promotions, port.demotions, port.version) == (
            jax.promotions, jax.demotions, jax.version)
        assert port.debug_vars() == jax.debug_vars()
        np.testing.assert_array_equal(port.hot_arr, jax.hot_arr)
    if name.startswith("hover") or name == "sustained_then_idle":
        assert port.promotions > 0 and port.demotions > 0
    else:
        assert port.promotions == 0 and not port.hot_set


def test_hotkey_env_parse_equal(monkeypatch):
    """The default environment turns the plane on in both packages, and
    the same GUBER_HOTKEY_* values parse (and fail) alike."""
    for var in ("GUBER_HOTKEY_ENABLED", "GUBER_LEASE_ENABLED"):
        monkeypatch.delenv(var, raising=False)
    assert pcfg.hotkey_config_from_env() == pcfg.HotKeyConfig()
    assert (dataclasses.asdict(pcfg.hotkey_config_from_env())
            == dataclasses.asdict(jcfg.hotkey_config_from_env()))
    assert pcfg.Config().hotkey.enabled and jcfg.Config().hotkey.enabled
    for k, v in {"GUBER_HOTKEY_THRESHOLD": "123.5",
                 "GUBER_HOTKEY_MIRRORS": "2",
                 "GUBER_HOTKEY_FRACTION": "0.1",
                 "GUBER_HOTKEY_WINDOW": "500ms",
                 "GUBER_HOTKEY_SHED_PRIORITIES": "bulk.*, mid.*",
                 "GUBER_HOTKEY_ENABLED": "false"}.items():
        monkeypatch.setenv(k, v)
    got = dataclasses.asdict(pcfg.hotkey_config_from_env())
    assert got == dataclasses.asdict(jcfg.hotkey_config_from_env())
    assert got["window_s"] == 0.5 and not got["enabled"]
    assert got["shed_priorities"] == ["bulk.*", "mid.*"]
    monkeypatch.setenv("GUBER_HOTKEY_FRACTION", "1.5")
    for mod in (pcfg, jcfg):
        with pytest.raises(ValueError, match="hot-key"):
            mod.hotkey_config_from_env()


class _FakePeer:
    def __init__(self, addr):
        self.grpc_address = addr

    def info(self):
        return self


def test_next_arc_mirror_sets_equal():
    addrs = [f"10.0.0.{i}:81" for i in range(6)]
    rings = [PRing(), JRing()]
    for ring in rings:
        for a in addrs:
            ring.add(_FakePeer(a))
    for i in range(300):
        key = f"hot_k{i}"
        for n in (2, 3):
            got, want = ([p.info().grpc_address for p in r.get_n(key, n)]
                         for r in rings)
            assert got == want and len(set(got)) == n
            assert got[0] == rings[0].get(key).info().grpc_address
        h = rings[0].hash_fn(key.encode())
        assert ([p.grpc_address for p in rings[0].get_n_hashed(h, 2)]
                == [p.grpc_address for p in rings[1].get_n_hashed(h, 2)])


class _Pressure:
    """A flight recorder whose breach run has lasted `sustained` s."""

    breaches = 0

    def __init__(self):
        self.sustained = 0.0

    def pressure_sustained_s(self):
        return self.sustained

    def pressure_active(self):
        return self.sustained > 0

    def pressure_ratio(self):
        return 2.0 if self.sustained > 0 else 0.0

    def __getattr__(self, name):
        # Every other recorder hook (batch and step records) is a no-op.
        return lambda *a, **kw: None


def test_shed_levels_priority_ordered_and_equal(frozen_clock):
    """Level L sheds the first L priority classes, escalating one class a
    cooldown and capped at the class count; unmatched names never shed.
    Both packages answer the same batch alike at every level, and shed
    requests leave no row behind."""
    t0 = frozen_clock.now_ns()
    hk = dict(shed_cooldown_s=0.4, shed_priorities=["bulk.*", "mid.*"])

    def scenario(port):
        mod, types = (pcfg, pt) if port else (jcfg, jt)
        cfg = mod.Config(
            device=(mod.DeviceConfig(platform="cpu", **CPU) if port
                    else mod.DeviceConfig(**CPU)),
            hotkey=mod.HotKeyConfig(**hk))
        svc = (Service if port else JaxService)(cfg, clock=frozen_clock)
        fr = _Pressure()
        svc.metrics.flightrec = fr

        async def run():
            await svc.start()
            out = []
            try:
                for s in (0.0, 0.3, 0.5, 0.9, 100.0):
                    fr.sustained = s
                    resps = await svc.get_rate_limits([
                        types.RateLimitReq(name=n, unique_key="u", hits=1,
                                           limit=10, duration=60_000)
                        for n in ("bulk.jobs", "mid.x", "keep")])
                    out.append((svc.shed_level(), [
                        (int(r.status), r.remaining, r.reset_time,
                         dict(r.metadata or {})) for r in resps]))
                out.append([svc.shed_priority(n)
                            for n in ("bulk.x", "mid.x", "keep")])
                out.append(svc.backend.get_cache_item("bulk.jobs_u").remaining)
                out.append((svc.shed_served,
                            (await svc.health_check()).message))
            finally:
                await svc.close()
            return out

        return asyncio.run(run())

    got = scenario(True)
    frozen_clock.freeze(t0)
    want = scenario(False)
    assert got == want
    assert [lvl for lvl, _ in got[:5]] == [0, 0, 1, 2, 2]
    assert got[5] == [0, 1, 2]
    shed = [[(r[3].get("shed") == "pressure") for r in rs]
            for _, rs in got[:5]]
    assert shed == [[False] * 3, [False] * 3, [True, False, False],
                    [True, True, False], [True, True, False]]
    # bulk.jobs was applied only at levels 0 (twice): 10 - 2.
    assert got[6] == 8
    assert got[7][0] == 5 and "Pressure shedding active" in got[7][1]


# ---------------------------------------------------------------------
# the lifecycle on a port cluster
# ---------------------------------------------------------------------

LIMIT = 200
FRACTION = 0.25
# Long enough that no bucket refills while the test runs on a real clock.
DURATION = 600_000


@pytest.fixture(scope="module")
def hot_cluster():
    conf = pcfg.DaemonConfig(
        flightrec=True,
        hotkey=pcfg.HotKeyConfig(
            threshold=50.0, mirrors=1, fraction=FRACTION, window_s=0.3,
            promote_windows=2, demote_windows=2, pressure_ttl_s=1.5,
        ),
    )
    c = Cluster.start_with(
        ["", "", ""], conf_template=conf,
        device=pcfg.DeviceConfig(platform="cpu", **CPU))
    for d in c.daemons:
        # No organic pressure on the CPU: the test lowers the owner's
        # target on purpose and restores it.
        d.flightrec.slo_p99_ms = 1e9
        d.flightrec.window_s = 2.0
    yield c
    c.stop()


def test_port_cluster_lifecycle_exact_mirror_bound(hot_cluster):
    """Saturate the owner's row first (exactly LIMIT admitted), then
    pressure the owner: daemon 0, the key's first next-arc mirror,
    promotes it and serves its mirror slot at FRACTION x LIMIT, so the
    cluster admits exactly LIMIT x (1 + mirrors x FRACTION).  Restoring
    the target collapses the widening and drops the mirror slot."""
    c = hot_cluster
    d0 = c.daemons[0]
    key = next(
        f"h{i}" for i in range(2000)
        if (lambda cand: not cand[0].info().is_owner
            and cand[1].info().is_owner)(
                d0.service.local_picker.get_n(f"hot_h{i}", 2)))
    hash_key = f"hot_{key}"
    owner = c.owner_daemon_of(hash_key)
    req = pt.RateLimitReq(name="hot", unique_key=key, hits=1, limit=LIMIT,
                          duration=DURATION)
    direct, cl = V1Client(owner.grpc_address), V1Client(d0.grpc_address)
    admitted = mirrored = 0
    try:
        for _ in range(LIMIT + 20):
            r = direct.get_rate_limits([req], timeout=30)[0]
            admitted += r.error == "" and r.status == pt.Status.UNDER_LIMIT
        assert admitted == LIMIT
        assert d0.service.mirror_served == 0

        owner.flightrec.slo_p99_ms = 1e-4  # every real RPC breaches

        def storm():
            nonlocal admitted, mirrored
            for r in cl.get_rate_limits([req] * 50, timeout=30):
                admitted += (r.error == ""
                             and r.status == pt.Status.UNDER_LIMIT)
                mirrored += (r.metadata or {}).get("hotkey") == "mirror"
            assert mirrored > int(LIMIT * FRACTION)

        until_pass(storm, timeout=30.0, interval=0.05)
        assert admitted == int(LIMIT * (1 + 1 * FRACTION))
        slot = d0.service.backend.get_cache_item(
            hash_key + phot.MIRROR_SUFFIX)
        assert slot.limit == int(LIMIT * FRACTION) and slot.remaining == 0
        assert d0.service.hotkeys.promotions >= 1

        owner.flightrec.slo_p99_ms = 1e9

        def collapsed():
            cl.get_rate_limits([pt.RateLimitReq(
                name="probe", unique_key="p", hits=1, limit=LIMIT,
                duration=DURATION)], timeout=30)
            assert not d0.service.hotkeys.hot_set
            assert d0.service.backend.get_cache_item(
                hash_key + phot.MIRROR_SUFFIX) is None
            assert not len(
                d0.service.derived_slot_fps_by_plane()[phot.MIRROR_SUFFIX])

        until_pass(collapsed, timeout=30.0, interval=0.2)
        assert d0.service.hotkeys.demotions >= 1
    finally:
        owner.flightrec.slo_p99_ms = 1e9
        direct.close()
        cl.close()
