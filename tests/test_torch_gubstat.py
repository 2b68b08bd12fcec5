"""The port's gubstat (gubernator_tpu_torch/runtime/gubstat.py over the
backend's table_stats_dispatch, the daemon's /debug/vars blocks and
/debug/key, cli/gubtop.py) against the JAX package's, on the CPU.

The scenarios of tests/test_gubstat.py run on both packages from one
frozen instant: the census of a served table (and an independent numpy
census of its snapshot), the sampler's block through the ring's host-job
lane with no request-path fetch, the tenant ledger, and a daemon's
`table`/`tenants` blocks, key peek and gubtop screen.  Counts are
integers and equal."""
from __future__ import annotations

import asyncio
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gubernator_tpu.core import clock as jclock
from gubernator_tpu.core import config as jcfg
from gubernator_tpu.core import types as jt
from gubernator_tpu.runtime import gubstat as jstat
from gubernator_tpu.runtime.backend import DeviceBackend
from gubernator_tpu.runtime.service import Service as JaxService
from gubernator_tpu_torch.core import clock as pclock
from gubernator_tpu_torch.core import config as pcfg
from gubernator_tpu_torch.core import types as pt
from gubernator_tpu_torch.core.hashing import bulk_key_hash64
from gubernator_tpu_torch.ops.state import AGE_BIN_EDGES_MS, SHADOW_PLANES
from gubernator_tpu_torch.runtime import gubstat as pstat
from gubernator_tpu_torch.runtime.backend import TorchBackend
from gubernator_tpu_torch.runtime.service import Service

SLOTS, WAYS, B = 2048, 8, 64


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
        self.stat = pstat if port else jstat
        self.cfg = pcfg if port else jcfg

    def device(self):
        if self.port:
            return pcfg.DeviceConfig(num_slots=SLOTS, ways=WAYS,
                                     batch_size=B, platform="cpu")
        return jcfg.DeviceConfig(num_slots=SLOTS, ways=WAYS, batch_size=B)

    def service(self, clock):
        if self.port:
            return Service(pcfg.Config(device=self.device()), clock=clock)
        return JaxService(jcfg.Config(
            device=self.device()), clock=clock)

    def req(self, name, key, hits=1, **kw):
        kw.setdefault("limit", 100)
        kw.setdefault("duration", 60_000)
        return self.types.RateLimitReq(name=name, unique_key=key, hits=hits,
                                       **kw)


PORT, JAX = Pkg(True), Pkg(False)


def in_turn(clock, scenario):
    t0 = clock.now_ns()
    got = scenario(PORT)
    clock.freeze(t0)
    return got, scenario(JAX)


def numpy_census(snap, grid, now, ways):
    """An independent census of a host snapshot, from the definitions of
    ops/state.table_stats."""
    key, expire, algo = snap["key"], snap["expire_at"], snap["algo"]
    nb = key.shape[0] // ways
    resident = key != 0
    alive = resident & (expire > now)
    fill = resident.reshape(nb, ways).sum(axis=1)
    edges = np.asarray(AGE_BIN_EDGES_MS)

    def hist(values):
        idx = (values[:, None] > edges[None, :]).sum(axis=1)
        return [int(((idx == b) & alive).sum()) for b in range(len(edges) + 1)]

    lim = np.maximum(snap["limit"].astype(np.float64), 1.0)
    rem = np.where(algo == 1, snap["remaining_f"],
                   snap["remaining"].astype(np.float64))
    fbin = np.minimum((np.clip(rem / lim, 0.0, 1.0) * 8).astype(np.int64), 7)
    shadow = []
    for plane in grid:
        n = 0
        for fp in plane[plane != 0]:
            b = int(np.uint64(fp) & np.uint64(nb - 1))
            row = slice(b * ways, (b + 1) * ways)
            n += bool(((key[row] == fp) & (expire[row] > now)).any())
        shadow.append(n)
    return dict(
        occupancy=int(resident.sum()), live=int(alive.sum()),
        expired_resident=int((resident & ~alive).sum()),
        bucket_fill=[int((fill == f).sum()) for f in range(ways + 1)],
        slot_age=hist(now - snap["t0"]), ttl_remaining=hist(expire - now),
        remaining_fraction=[[int(((fbin == b) & alive & (algo == a)).sum())
                             for b in range(8)] for a in (0, 1)],
        shadow_slots=shadow)


def test_census_dispatch_matches_jax_and_a_numpy_census(frozen_clock):
    """A table served through mixed algorithms, durations and expiries:
    the port's census equals the JAX backend's leaf for leaf and an
    independent numpy census of the snapshot."""
    def scenario(P):
        be = (TorchBackend if P.port else DeviceBackend)(
            P.device(), clock=frozen_clock)
        for w in range(4):
            be.check([P.req("c", f"k{w}_{i}", hits=i % 7, limit=10 + i % 5,
                            duration=(1_000, 30_000, 3_600_000)[i % 3],
                            algorithm=i % 2) for i in range(150)])
            frozen_clock.advance(7_000)
        grid = np.zeros((len(SHADOW_PLANES), 8), dtype=np.int64)
        grid[1, :3] = bulk_key_hash64(["c_k3_1", "c_k3_2", "c_k0_0"])
        grid[3, 0] = 12345
        st = be.table_stats_dispatch(grid)()
        return ({f: np.asarray(getattr(st, f)) for f in st._fields},
                be.snapshot(), grid, frozen_clock.millisecond_now())

    (st, snap, grid, now), (jst, *_) = in_turn(frozen_clock, scenario)
    for f in jst:
        assert st[f].dtype == jst[f].dtype, f
        np.testing.assert_array_equal(st[f], jst[f], err_msg=f)
    ref = numpy_census(snap, grid, now, WAYS)
    for f, v in ref.items():
        assert np.asarray(st[f])[0].tolist() == v, f
    assert ref["expired_resident"] > 0 and ref["shadow_slots"][1] == 2


def test_sampler_block_in_ring_mode_matches_jax(frozen_clock):
    """The sampler's published block equals the JAX sampler's, and
    sampling through the ring's host-job lane leaves the fast lane's
    blocking-fetch ledger untouched."""
    from gubernator_tpu.runtime.fastpath import FastPath as JaxFastPath
    from gubernator_tpu_torch.runtime.fastpath import FastPath

    def scenario(P):
        async def run():
            svc = P.service(frozen_clock)
            await svc.start()
            fp = (FastPath if P.port else JaxFastPath)(
                svc, serve_mode="ring", ring_slots=2)
            try:
                await svc._check_local([P.req("r", f"k{i}", limit=20,
                                              algorithm=i % 2)
                                        for i in range(40)])
                before = dict(fp.blocking_fetches)
                sampler = P.stat.TableStatsSampler(svc, fastpath=fp)
                blocks = [await sampler.sample() for _ in range(3)]
                assert fp.blocking_fetches == before
                return blocks, sampler.samples, sampler.errors, \
                    fp.effective_serve_mode
            finally:
                await fp.close()
                await svc.close()

        return asyncio.run(run())

    got, want = in_turn(frozen_clock, scenario)
    assert got == want
    blocks, samples, errors, mode = got
    assert (samples, errors, mode) == (3, 0, "ring")
    assert blocks[-1]["occupancy"] >= 40


def test_tenant_ledger_matches_jax():
    """Attribution by name and plane, zero-hit peeks, shedding, the fast
    lane's vectorized record with lazy name decodes, and the bounded
    ledger under a name sweep: the same top and debug block."""
    def scenario(P):
        ta = P.stat.TenantAccounting(top_k=4)
        reqs = [P.req("a", "k", hits=3), P.req("a", "k.hot-mirror", hits=2),
                P.req("a", "k2", hits=4), P.req("b", "x", hits=0),
                P.req("c", "y.handoff-shadow", hits=5)]

        class R:
            def __init__(self, s):
                self.status = s

        ta.record_checks(reqs, [R(0), R(0), R(1), R(0), R(0)])
        ta.record_shed("a", 5)
        names = ["fast_a", "fast_a", "fast_b", "fast_c"]
        decoded = []
        ta.record_fast(np.asarray(P.stat.TenantAccounting.name_fingerprints(
            names)), np.array([2, 3, 1, 4], dtype=np.int64),
            np.array([0, 1, 0, 0], dtype=np.int64),
            np.array([True, True, True, False]),
            lambda i: decoded.append(i) or names[i])
        for i in range(ta._cap * 3):
            ta.record(f"sweep{i}", 1, "allowed")
        for _ in range(50):
            ta.record("heavy", 7, "allowed")
        return ta.top(), ta.debug_vars(), decoded, ta.dropped

    got, want = scenario(PORT), scenario(JAX)
    assert got == want
    top, _, decoded, dropped = got
    assert top[0]["name"] == "heavy" and dropped > 0
    assert sorted(decoded) == [0, 2]
    assert [P.stat.classify_plane(k) for P in (PORT, JAX)
            for k in ("u", "u.hot-mirror", "u.region-carve")] == \
        ["", "hot-mirror", "region-carve"] * 2
    assert pstat.PLANE_LABELS == jstat.PLANE_LABELS


def test_tenant_publish_removes_stale_labels():
    from gubernator_tpu_torch.runtime.metrics import Metrics

    m = Metrics()
    ta = pstat.TenantAccounting(top_k=1)
    ta.record("one", 5, "allowed")
    ta.publish(m)
    assert m.registry.get_sample_value(
        "gubernator_tenant_hits", {"name": "one", "outcome": "allowed"}) == 5
    ta.record("two", 50, "allowed", plane="hot-mirror")
    ta.publish(m)
    assert m.registry.get_sample_value(
        "gubernator_tenant_hits", {"name": "one", "outcome": "allowed"}) is None
    assert m.registry.get_sample_value(
        "gubernator_tenant_over_admitted",
        {"name": "two", "plane": "hot-mirror"}) == 50


def cluster_scenario(P, t0_ns):
    """One daemon with the sampler on a short interval: drive RPCs, wait
    for a census that sees them, then read /debug/vars, /debug/key (twice,
    plus an absent key and the peek gate) and gubtop's screen."""
    from gubernator_tpu.cli import gubtop as jtop
    from gubernator_tpu.client import V1Client
    from gubernator_tpu.testing.cluster import Cluster as JCluster
    from gubernator_tpu_torch.cli import gubtop as ptop
    from gubernator_tpu_torch.testing.cluster import Cluster

    if P.port:
        pclock.freeze(t0_ns)
        c = Cluster.start(1, device=P.device(), conf_template=pcfg.DaemonConfig(
            stats=pcfg.StatsConfig(interval_s=0.2)))
    else:
        jclock.freeze(t0_ns)
        c = JCluster.start(1, device=P.device(), conf_template=jcfg.DaemonConfig(
            stats=jcfg.StatsConfig(interval_s=0.2)))
    try:
        d = c.daemons[0]
        cl = V1Client(d.grpc_address)
        try:
            for j in range(3):
                cl.get_rate_limits([jt.RateLimitReq(
                    name="schema", unique_key=f"k{i}", hits=1 + j, limit=5,
                    duration=60_000, algorithm=i % 2) for i in range(8)])
        finally:
            cl.close()

        def get(path):
            with urllib.request.urlopen(
                    f"http://{d.http_address}{path}", timeout=10) as r:
                return json.loads(r.read())

        import time
        deadline = time.monotonic() + 20
        while get("/debug/vars").get("table", {}).get("occupancy", 0) < 8:
            assert time.monotonic() < deadline, "the sampler never caught up"
            time.sleep(0.05)
        v = get("/debug/vars")
        table = {k: x for k, x in v["table"].items()
                 if k not in ("samples", "errors")}
        keys = [get("/debug/key?name=schema&key=k0"),
                get("/debug/key?name=schema&key=k1"),
                get("/debug/key?name=schema&key=k0"),
                get("/debug/key?name=schema&key=nope")]
        for k in keys:
            k.pop("served_by"), k.pop("owner")
        d.service.cfg.stats.peek = False
        with pytest.raises(urllib.error.HTTPError) as ei:
            get("/debug/key?name=schema&key=k0")
        d.service.cfg.stats.peek = True
        # The screen's first line carries the wall-clock time.
        screen = (ptop if P.port else jtop).render(
            [d.http_address]).split("\n", 1)[1]
        return (sorted(v), table, v["tenants"], keys, ei.value.code,
                screen.replace(d.http_address, "ADDR").replace(
                    d.grpc_address, "GRPC"))
    finally:
        c.stop()
        (pclock if P.port else jclock).unfreeze()


def test_daemon_blocks_key_peek_and_gubtop_match_jax(frozen_clock):
    """The port's daemon answers /debug/vars (`table`, `tenants` and the
    rest of the schema), /debug/key (non-mutating, gated by the peek knob)
    and gubtop's screen as the JAX daemon does on the same traffic."""
    t0 = frozen_clock.now_ns()
    got = cluster_scenario(PORT, t0)
    want = cluster_scenario(JAX, t0)
    frozen_clock.freeze(t0)
    schema, table, tenants, keys, gate, screen = got
    assert set(schema) == set(want[0])
    assert "table" in schema and "tenants" in schema and "reshard" in schema
    assert table == want[1] and tenants == want[2]
    assert keys == want[3] and gate == want[4] == 403
    assert screen == want[5]
    assert keys[0] == keys[2] and keys[0]["found"] and not keys[3]["found"]
    assert keys[0]["row"]["remaining"] == 2.0 and keys[0]["row"]["limit"] == 5
    assert tenants["top"][0]["name"] == "schema"


def test_stats_env_plumbing(monkeypatch):
    """GUBER_STATS_* flows env -> the port's DaemonConfig; the plane is on
    by default, as in the JAX package."""
    from gubernator_tpu_torch.core.config import setup_daemon_config

    assert setup_daemon_config().stats.enabled is True
    monkeypatch.setenv("GUBER_STATS_ENABLED", "false")
    monkeypatch.setenv("GUBER_STATS_INTERVAL", "9s")
    monkeypatch.setenv("GUBER_STATS_TOP_K", "7")
    monkeypatch.setenv("GUBER_STATS_PEEK", "false")
    conf = setup_daemon_config()
    assert (conf.stats.enabled, conf.stats.interval_s, conf.stats.top_k,
            conf.stats.peek) == (False, 9.0, 7, False)
