"""The port's service (gubernator_tpu_torch/runtime/service.py) on the CPU
against the JAX package's, on one request stream.

The object path (`get_rate_limits`, `get_peer_rate_limits`), the GLOBAL
broadcast receive (`update_peer_globals` through the port's
`store_cached_rows`), `health_check` and the planes' peer RPCs answer as the
JAX service answers; `MAX_BATCH_SIZE` raises the same ApiError; every
configuration of the JAX package constructs, the sharded table included;
under the default environment both daemons grant leases
alike."""
from __future__ import annotations

import asyncio
import dataclasses
import random

import numpy as np
import pytest
import torch

from gubernator_tpu.core import config as jcfg
from gubernator_tpu.core import types as jt
from gubernator_tpu.runtime.service import ApiError as JaxApiError
from gubernator_tpu.runtime.service import Service as JaxService
from gubernator_tpu_torch.core import config as pcfg
from gubernator_tpu_torch.core import types as pt
from gubernator_tpu_torch.runtime.service import ApiError, Service

SLOTS, WAYS, B = 1024, 8, 64
SKETCH = dict(names=["sk"], width=1024, window_ms=1000, batch_size=64)
GLOBAL, GREG, RESET = 2, 4, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_service(clock, **kw) -> Service:
    kw.setdefault("reshard", pcfg.ReshardConfig(enabled=False))
    kw.setdefault("stats", pcfg.StatsConfig(enabled=False))
    return Service(pcfg.Config(
        device=pcfg.DeviceConfig(num_slots=SLOTS, ways=WAYS, batch_size=B,
                                 platform="cpu"),
        sketch=pcfg.SketchTierConfig(**SKETCH), **kw), clock=clock)


def jax_service(clock) -> JaxService:
    return JaxService(jcfg.Config(
        device=jcfg.DeviceConfig(num_slots=SLOTS, ways=WAYS, batch_size=B),
        sketch=jcfg.SketchTierConfig(**SKETCH),
        reshard=jcfg.ReshardConfig(enabled=False),
        stats=jcfg.StatsConfig(enabled=False),
    ), clock=clock)


def stream(types, seed: int, n: int):
    """Batches of `types.RateLimitReq` (one module's class, same values)."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        batch = []
        for _ in range(rng.randrange(1, 25)):
            u = rng.random()
            if u < 0.1:
                k = rng.randrange(3)
                batch.append(types.RateLimitReq(
                    name="glob", unique_key=f"g{k}", hits=rng.choice([0, 1]),
                    limit=10, duration=60_000, algorithm=k % 2,
                    behavior=GLOBAL))
            elif u < 0.2:
                batch.append(types.RateLimitReq(
                    name="sk", unique_key=f"s{rng.randrange(9)}", hits=1,
                    limit=4, duration=1000))
            else:
                beh, dur = 0, rng.choice([60_000, 1_000])
                if rng.random() < 0.08:
                    beh |= RESET
                if rng.random() < 0.06:
                    beh |= GREG
                    dur = rng.choice([1, 3, 7])
                batch.append(types.RateLimitReq(
                    name=rng.choice(["o", "o", "o", ""]),
                    unique_key=rng.choice([f"k{i}" for i in range(8)] + [""]),
                    hits=rng.choice([0, 1, 1, 2, -1]),
                    limit=rng.choice([5, 20]), duration=dur,
                    algorithm=rng.choice([0, 1]), behavior=beh,
                    burst=rng.choice([0, 0, 30])))
        out.append(batch)
    return out


def resp_key(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error,
            dict(r.metadata or {}))


def both(clock, body):
    """Run `body(service, types)` on a port and a JAX service from the same
    frozen instant; returns both results and both tables."""
    t0 = clock.now_ns()

    async def go(make, types):
        svc = make(clock)
        await svc.start()
        try:
            return await asyncio.wait_for(body(svc, types), 60), \
                svc.backend.snapshot()
        finally:
            await svc.close()

    got = asyncio.run(go(port_service, pt))
    clock.freeze(t0)
    want = asyncio.run(go(jax_service, jt))
    return got, want


def assert_tables(a, b):
    for f in b:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("peer", [False, True])
def test_object_path_matches_jax_service(peer, frozen_clock):
    async def body(svc, types):
        out = []
        for i, batch in enumerate(stream(types, 17 + peer, 20)):
            call = svc.get_peer_rate_limits if peer else svc.get_rate_limits
            out.append([resp_key(r) for r in await call(batch)])
            if i % 4 == 3:
                svc.clock.advance(600)
        return out

    (got, table), (want, jtable) = both(frozen_clock, body)
    assert got == want
    assert_tables(table, jtable)


def test_update_peer_globals_matches_jax(frozen_clock):
    """Owner broadcasts land as KIND_CACHED_RESP rows through the port's
    store_cached_rows exactly where the JAX op puts them, and a cached
    (non-owner) read then serves them verbatim."""
    async def body(svc, types):
        rng = random.Random(4)
        await svc.get_rate_limits([types.RateLimitReq(
            name="o", unique_key=f"k{i}", hits=1, limit=9, duration=60_000)
            for i in range(40)])
        now = svc.clock.millisecond_now()
        ups = [types.UpdatePeerGlobal(
            key=f"glob_g{i}", algorithm=types.Algorithm(i % 2),
            status=types.RateLimitResp(
                status=types.Status(rng.randrange(2)), limit=50,
                remaining=rng.randrange(50),
                reset_time=now + rng.choice([-5, 1_000, 60_000])))
            for i in range(90)]
        await svc.update_peer_globals(ups)
        reads = [types.RateLimitReq(name="glob", unique_key=f"g{i}", hits=1,
                                    limit=50, duration=60_000,
                                    behavior=GLOBAL) for i in range(0, 90, 7)]
        resps = await svc._check_local(reads, [True] * len(reads))
        return [resp_key(r) for r in resps]

    (got, table), (want, jtable) = both(frozen_clock, body)
    assert got == want
    assert_tables(table, jtable)
    assert int((table["kind"] == 1).sum()) > 0


def test_store_cached_rows_matches_jax_op():
    """The op itself, on a seeded branch-covering table: crowded buckets
    (claims, transient drops), live and expired rows, inactive lanes."""
    from gubernator_tpu.ops.state import table_from_host as jax_from_host
    from gubernator_tpu.ops.step import CachedRows as JRows
    from gubernator_tpu.ops.step import store_cached_rows as jax_store
    from gubernator_tpu_torch.ops.state import table_from_host, table_to_host
    from gubernator_tpu_torch.ops.step import CachedRows, store_cached_rows
    from gubernator_tpu_torch.testing import KeySpace, random_table

    rng = np.random.default_rng(12)
    now = 1_700_000_000_000
    ks = KeySpace(rng, 256, 8, hot_buckets=4)
    host = random_table(rng, ks, now)
    keys = np.unique(np.concatenate([ks.hot_keys, ks.in_bucket(
        rng.integers(0, ks.nb, 40))]))[:64]
    keys[rng.random(len(keys)) < 0.1] = 0
    cols = dict(key_hash=keys.astype(np.int64),
                algo=rng.integers(0, 2, len(keys)).astype(np.int32),
                limit=rng.integers(1, 100, len(keys)).astype(np.int64),
                remaining=rng.integers(0, 100, len(keys)).astype(np.int64),
                status=rng.integers(0, 2, len(keys)).astype(np.int32),
                reset_time=now + rng.integers(-10, 10_000, len(keys)))
    got = table_to_host(store_cached_rows(
        table_from_host(host, "cpu"),
        CachedRows(**{k: torch.from_numpy(v) for k, v in cols.items()}),
        now))
    want = jax_store(jax_from_host(host), JRows(**cols), np.int64(now),
                     ways=8)
    for f in got:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_health_and_disabled_plane_rpcs_match_jax(frozen_clock):
    async def body(svc, types):
        h = await svc.health_check()
        reqs = [types.RateLimitReq(name="l", unique_key="a", hits=1,
                                   limit=7, duration=1000)]
        lease = await svc.lease("c1", reqs)
        rec = await svc.reconcile("c1", [types.ReconcileItem(
            request=reqs[0], renew=True)])
        hand = await svc.handoff("x:1", 1, "begin", 5)
        try:
            await svc.migrate("x:1", 1, b"", True)
            mig = None
        except Exception as e:  # noqa: BLE001 — compared below
            mig = (e.code, str(e))
        return (dataclasses.astuple(h),
                [dataclasses.astuple(g) for g in lease + rec], hand, mig)

    (got, _), (want, _) = both(frozen_clock, body)
    assert got == want
    assert got[0][0] == "healthy" and got[3][0] == "FAILED_PRECONDITION"
    # Leases are on by default in both packages: the grant carves a
    # quarter of the limit and the renewing reconcile grants again.
    assert [g[-1] for g in got[1]] == ["", ""] and got[1][0][1] == 1


def test_oversized_batch_raises_the_same_api_error(frozen_clock):
    async def body(svc, types):
        reqs = [types.RateLimitReq(name="n", unique_key=f"k{i}", hits=1,
                                   limit=5, duration=1000)
                for i in range(1001)]
        out = []
        for call in (svc.get_rate_limits, svc.get_peer_rate_limits):
            try:
                await call(reqs)
            except (ApiError, JaxApiError) as e:
                out.append((e.code, str(e)))
        return out

    (got, _), (want, _) = both(frozen_clock, body)
    assert got == want and len(got) == 2
    assert {c for c, _ in got} == {"OUT_OF_RANGE"}


def test_unported_configurations_raise_naming_their_roadmap_item():
    cpu = pcfg.DeviceConfig(num_slots=256, ways=8, batch_size=16,
                            platform="cpu")
    # Nothing is refused any more: the sharded table (the mesh) is
    # served, by the mesh backend and the collective GLOBAL engine, and
    # a geometry the JAX package rejects is rejected with its message.
    from gubernator_tpu_torch.parallel.global_sync import GlobalEngine
    from gubernator_tpu_torch.parallel.sharded import MeshBackend

    svc = Service(pcfg.Config(device=pcfg.DeviceConfig(
        num_slots=256, ways=8, batch_size=16, num_shards=2,
        platform="cpu")))
    assert isinstance(svc.backend, MeshBackend)
    assert isinstance(svc.global_engine, GlobalEngine)
    svc._dev_executor.shutdown()
    with pytest.raises(ValueError, match="divisible by ways\\*num_shards"):
        pcfg.DeviceConfig(num_slots=256, ways=8, num_shards=3)
    # The region plane is served.
    svc = Service(pcfg.Config(device=cpu,
                              region=pcfg.RegionConfig(enabled=True, name="a")))
    assert svc.regions is not None and svc.regions.universe() == ("a",)
    svc._dev_executor.shutdown()
    # The hot-key and lease planes are served and on by default, as in
    # the JAX package.
    assert pcfg.HotKeyConfig().enabled and pcfg.LeaseConfig().enabled
    svc = Service(pcfg.Config(device=cpu))
    assert svc.hotkeys is not None and svc.leases is not None
    svc._dev_executor.shutdown()
    # The state plane is served: a Store, a Loader, resharding, gubstat
    # and the cold tier's config construct, and reshard and stats are on
    # by default, as in the JAX package.
    from gubernator_tpu_torch.runtime.store import MockLoader, MockStore

    assert pcfg.ReshardConfig().enabled and pcfg.StatsConfig().enabled
    assert not pcfg.TierConfig().enabled
    for kw in (dict(store=MockStore()), dict(loader=MockLoader()),
               dict(tier=pcfg.TierConfig(enabled=True))):
        svc = Service(pcfg.Config(device=cpu, **kw))
        assert svc.reshard is not None and svc.tenants is not None
        svc._dev_executor.shutdown()

    from gubernator_tpu_torch.daemon import Daemon

    # Every discovery kind is served: the daemons construct (their pools
    # start with the daemon).
    for kind in ("dns", "gossip", "k8s", "etcd"):
        assert Daemon(pcfg.DaemonConfig(
            device=cpu, peer_discovery_type=kind)).conf.peer_discovery_type \
            == kind
    Daemon(pcfg.DaemonConfig(device=cpu, reshard_drain_on_close=True))
    # The chaos plane is served: a daemon takes an injector.
    from gubernator_tpu_torch.testing.chaos import ChaosInjector, ChaosPlan

    inj = ChaosInjector(ChaosPlan(seed=1))
    assert Daemon(pcfg.DaemonConfig(device=cpu, chaos=inj)).chaos is inj


def test_default_environment_leases_and_hot_keys_match_jax(monkeypatch,
                                                          frozen_clock):
    """Under the default environment both packages' daemons arm the
    hot-key and lease planes, and a Lease RPC over the peers wire gets
    equal grants from each (a quarter of the limit, from the carve slot)."""
    import os

    import grpc

    from gubernator_tpu import daemon as jdaemon
    from gubernator_tpu_torch import daemon as pdaemon
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb
    from gubernator_tpu_torch.proto import peers_pb2

    for k in [k for k in os.environ if k.startswith("GUBER_")]:
        monkeypatch.delenv(k)
    assert pcfg.Config().hotkey.enabled and pcfg.Config().lease.enabled
    assert jcfg.Config().hotkey.enabled and jcfg.Config().lease.enabled
    for k, v in {"GUBER_GRPC_ADDRESS": "127.0.0.1:0",
                 "GUBER_HTTP_ADDRESS": "127.0.0.1:0",
                 "GUBER_TPU_PLATFORM": "cpu", "GUBER_TPU_NUM_SLOTS": "1024",
                 "GUBER_TPU_BATCH_SIZE": "64"}.items():
        monkeypatch.setenv(k, v)
    lease_req = peers_pb2.LeaseReq(client_id="c1", requests=[
        pb.RateLimitReq(name="dl", unique_key=f"k{i}", hits=1, limit=lim,
                        duration=60_000, algorithm=i % 2)
        for i, lim in enumerate((100, 7, 0, 1000))]).SerializeToString()

    async def scenario(mod, cfg):
        conf = cfg.setup_daemon_config()
        assert conf.hotkey.enabled and conf.lease.enabled
        d = mod.Daemon(conf, clock=frozen_clock)
        await d.start()
        try:
            assert d.service.hotkeys is not None
            async with grpc.aio.insecure_channel(d.grpc_address) as ch:
                raw = await ch.unary_unary("/pb.gubernator.PeersV1/Lease")(
                    lease_req)
            return [(g.key, g.allowance, g.expires_at, g.reset_time,
                     g.limit, g.refusal)
                    for g in peers_pb2.LeaseResp.FromString(raw).grants]
        finally:
            await d.close()

    t0 = frozen_clock.now_ns()
    got = asyncio.run(scenario(pdaemon, pcfg))
    frozen_clock.freeze(t0)
    want = asyncio.run(scenario(jdaemon, jcfg))
    assert got == want
    assert [g[1] for g in got] == [25, 1, 0, 250]
    assert got[2][-1] and not got[0][-1]


def test_default_platform_is_the_card():
    """A service built without a platform asks for CUDA: here, where there
    is none, it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Service(pcfg.Config())
