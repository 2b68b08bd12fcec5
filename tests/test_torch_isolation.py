"""gubernator_tpu_torch stands alone: in a fresh interpreter where `jax` and
the JAX package cannot be imported, the port imports and answers a check()
on the CPU from the exact engine, the sketch tier and a 4-shard mesh (whose
collective GLOBAL engine syncs once), the bench entry points, the graft
entry (one decision step), the oracle and raceguard import, and no module
named jax, gubernator_tpu, gubernator_tpu.* or tools is ever loaded
(gubernator_tpu_torch itself must pass the prefix test)."""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import importlib.abc
    import sys

    def blocked(name):
        top = name.split(".")[0]
        return top in ("jax", "jaxlib", "gubernator_tpu", "tools")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())

    import gubernator_tpu_torch
    from gubernator_tpu_torch.core.config import DeviceConfig
    from gubernator_tpu_torch.core.types import RateLimitReq
    from gubernator_tpu_torch.runtime.backend import TorchBackend

    be = TorchBackend(DeviceConfig(num_slots=256, ways=8, batch_size=16,
                                   platform="cpu"))
    r = be.check([RateLimitReq(name="iso", unique_key="k", hits=1, limit=5,
                               duration=60_000)])[0]
    assert (r.error, r.remaining) == ("", 4), r

    from gubernator_tpu_torch.core.config import SketchTierConfig
    from gubernator_tpu_torch.ops import sketch
    from gubernator_tpu_torch.ops.kernels import cms_kernel
    from gubernator_tpu_torch.runtime.sketch_backend import SketchBackend

    sb = SketchBackend(SketchTierConfig(names=["iso"], width=1024,
                                        batch_size=16), device="cpu")
    reqs = [RateLimitReq(name="iso", unique_key="k", hits=2, limit=3,
                         duration=1000)] * 2
    assert [x.remaining for x in sb.check(reqs)] == [1, 1]
    s = sb.check(reqs[:1])[0]
    assert (int(s.status), s.metadata) == (1, {"tier": "sketch"}), s
    # The sharded table and the collective GLOBAL engine.
    from gubernator_tpu_torch.parallel import global_sync, mesh, sharded

    mb = sharded.MeshBackend(DeviceConfig(num_slots=1024, ways=8,
                                          batch_size=16, num_shards=4,
                                          platform="cpu"))
    r = mb.check([RateLimitReq(name="iso", unique_key="k", hits=1, limit=5,
                               duration=60_000)])[0]
    assert (r.error, r.remaining) == ("", 4), r
    eng = global_sync.GlobalEngine(mb)
    g = RateLimitReq(name="iso", unique_key="g", hits=2, limit=5,
                     duration=60_000, behavior=2)
    assert eng.check([g])[0].remaining == 3
    assert eng.sync() == 1
    assert mb.get_cache_item("iso_g").remaining == 3
    assert sum(mb.shard_occupancy()) == mb.occupancy() == 2
    # The bench entry points, the graft entry, the oracle and raceguard.
    from gubernator_tpu_torch import graft
    from gubernator_tpu_torch.cli import bench, bench_e2e, microbench
    from gubernator_tpu_torch.core import pymodel
    from gubernator_tpu_torch.testing import raceguard

    fn, (tbl, q, now) = graft.entry(device="cpu")
    tbl, resp = fn(tbl, q, now)
    assert resp[2, :64].tolist() == [99] * 64
    assert bench.batch_from_keys(q[0]).shape == (12, 256)
    assert pymodel.PyRateLimiter().get_rate_limit(RateLimitReq(
        name="iso", unique_key="k", hits=1, limit=5,
        duration=60_000)).remaining == 4
    assert callable(bench_e2e.main) and callable(microbench.main)
    assert raceguard.LockOrderGraph().record(1, 2) is False
    bad = sorted(m for m in sys.modules if blocked(m))
    assert not bad, bad
    for m in ("runtime.backend", "runtime.sketch_backend", "ops.sketch",
              "ops.kernels.cms_kernel", "parallel.mesh", "parallel.sharded",
              "parallel.global_sync", "graft", "cli.bench", "cli.bench_e2e",
              "cli.microbench", "core.pymodel", "testing.raceguard"):
        assert "gubernator_tpu_torch." + m in sys.modules, m
    print("ISOLATED-OK")
""")


def test_port_imports_without_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED-OK" in proc.stdout


DAEMON_SCRIPT = SCRIPT.split("import gubernator_tpu_torch")[0] + textwrap.dedent("""
    import asyncio

    import grpc

    from gubernator_tpu_torch import client
    from gubernator_tpu_torch.core.config import DaemonConfig, DeviceConfig
    from gubernator_tpu_torch.core.types import RateLimitReq
    from gubernator_tpu_torch.daemon import Daemon
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb
    from gubernator_tpu_torch.runtime import hotkey, lease, multiregion
    from gubernator_tpu_torch.testing import chaos, tracing
    from gubernator_tpu_torch.discovery import dns, etcd, gossip, k8s
    from gubernator_tpu_torch import loadgen
    from gubernator_tpu_torch.loadgen import report
    from gubernator_tpu_torch.cli import (
        bench_client, cluster, flightrec, gubload, healthcheck)

    async def main():
        d = Daemon(DaemonConfig(
            grpc_listen_address="127.0.0.1:0",
            http_listen_address="127.0.0.1:0",
            device=DeviceConfig(num_slots=256, ways=8, batch_size=16,
                                platform="cpu"),
            chaos=chaos.ChaosInjector(chaos.ChaosPlan(seed=1))))
        await d.start()
        try:
            async with grpc.aio.insecure_channel(d.grpc_address) as ch:
                raw = await ch.unary_unary(
                    "/pb.gubernator.V1/GetRateLimits")(
                    pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
                        name="iso", unique_key="k", hits=1, limit=5,
                        duration=60_000)]).SerializeToString())
            r = pb.GetRateLimitsResp.FromString(raw).responses[0]
            assert (r.error, r.remaining) == ("", 4), r
            assert d.fastpath.served == 1 and d.fastpath.fallbacks == 0
            # The hot-key and lease planes are on by default: a Lease
            # grants a quarter of the limit from the carve slot.
            assert isinstance(d.service.hotkeys, hotkey.HotKeyTracker)
            g = (await d.service.lease("c", [RateLimitReq(
                name="iso", unique_key="l", hits=1, limit=8,
                duration=60_000)]))[0]
            assert (g.allowance, g.refusal) == (2, ""), g
            assert d.service.backend.get_cache_item(
                "iso_l" + lease.LEASE_SUFFIX) is not None
            assert d.service.chaos is not None
        finally:
            await d.close()

    asyncio.run(asyncio.wait_for(main(), 60))
    assert callable(client.LeasedClient) and tracing.MemorySpanExporter
    assert multiregion.REGION_SUFFIX == ".region-carve"
    assert report._platform() == "cpu" and "region_failover" in loadgen.SCENARIOS
    assert all(callable(m.main) for m in (
        bench_client, cluster, flightrec, gubload, healthcheck))
    assert dns.DnsPool and gossip.GossipPool and k8s.K8sPool and etcd.EtcdPool
    bad = sorted(m for m in sys.modules if blocked(m))
    assert not bad, bad
    for m in ("client", "runtime.hotkey", "runtime.lease", "testing.chaos",
              "testing.tracing", "runtime.multiregion", "discovery.dns",
              "discovery.gossip", "discovery.k8s", "discovery.etcd",
              "loadgen", "loadgen.engine", "loadgen.runner",
              "loadgen.scenarios", "loadgen.schedule", "loadgen.spec",
              "loadgen.report", "cli.bench_client", "cli.cluster",
              "cli.flightrec", "cli.gubload", "cli.healthcheck"):
        assert "gubernator_tpu_torch." + m in sys.modules, m
    print("DAEMON-ISOLATED-OK")
""")


def test_port_daemon_serves_without_jax():
    """With jax and the JAX package blocked, the port's daemon starts on
    the CPU with a chaos injector, answers one GetRateLimits over gRPC on
    its compiled lane and grants a lease; the client SDK, the hot-key,
    lease and region planes, the chaos and tracing fixtures, the four
    discovery pools, the load generator and the five CLIs import."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", DAEMON_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "DAEMON-ISOLATED-OK" in proc.stdout


STATE_SCRIPT = SCRIPT.split("import gubernator_tpu_torch")[0] + textwrap.dedent("""
    import asyncio
    import tempfile

    import numpy as np

    from gubernator_tpu_torch.cli import gubtop
    from gubernator_tpu_torch.core.config import (
        Config,
        DaemonConfig,
        DeviceConfig,
        TierConfig,
    )
    from gubernator_tpu_torch.core.hashing import bulk_key_hash64
    from gubernator_tpu_torch.core.types import RateLimitReq
    from gubernator_tpu_torch.daemon import Daemon
    from gubernator_tpu_torch.runtime.checkpoint import TableCheckpointer
    from gubernator_tpu_torch.runtime.coldtier import TierManager
    from gubernator_tpu_torch.runtime.reshard import compute_moved
    from gubernator_tpu_torch.runtime.service import Service
    from gubernator_tpu_torch.runtime.store import MockLoader, MockStore

    dev = DeviceConfig(num_slots=256, ways=8, batch_size=16, platform="cpu")
    reqs = [RateLimitReq(name="iso", unique_key=f"k{i}", hits=2, limit=5,
                         duration=60_000) for i in range(20)]

    async def persistence():
        store, loader = MockStore(), MockLoader()
        svc = Service(Config(device=dev, store=store, loader=loader))
        await svc.start()
        await svc.get_rate_limits(reqs)
        be = svc.backend
        with tempfile.TemporaryDirectory() as d:
            TableCheckpointer(d).save(be, step=1)
            TableCheckpointer(d).restore(be)
        st = be.table_stats_dispatch(np.zeros((5, 8), dtype=np.int64))()
        assert int(st.live[0]) == 20, st
        packed, rf = be.migrate_extract_rows(bulk_key_hash64(
            [r.hash_key() for r in reqs[:4]]))
        assert (packed[0] != 0).all()
        tier = TierManager(svc, TierConfig(enabled=True, cold_capacity=64,
                                           high_water=0.05, low_water=0.02,
                                           demote_batch=8))
        assert tier.demote_once_sync() > 0
        await svc.close()
        assert len(store.data) == 20 and loader.called["save"] == 1
        assert compute_moved(np.zeros(0, dtype=np.int64), svc.local_picker,
                             svc.local_picker) == {}

    async def daemon():
        d = Daemon(DaemonConfig(
            grpc_listen_address="127.0.0.1:0",
            http_listen_address="127.0.0.1:0", device=dev,
            tier=TierConfig(enabled=True, cold_capacity=64)))
        await d.start()
        try:
            await d.service.get_rate_limits(reqs[:1])
            assert d.stats_sampler is not None and d.tier is not None
            assert d.service.reshard is not None
            block = await d.stats_sampler.sample()
            assert block["live"] >= 1, block
        finally:
            await d.close()

    asyncio.run(asyncio.wait_for(persistence(), 60))
    asyncio.run(asyncio.wait_for(daemon(), 60))
    assert callable(gubtop.render)
    bad = sorted(m for m in sys.modules if blocked(m))
    assert not bad, bad
    for m in ("runtime.checkpoint", "runtime.coldtier", "runtime.reshard",
              "runtime.gubstat", "runtime.store", "cli.gubtop"):
        assert "gubernator_tpu_torch." + m in sys.modules, m
    print("STATE-ISOLATED-OK")
""")


def test_port_state_plane_runs_without_jax():
    """With jax and the JAX package blocked, the state plane runs on the
    CPU: Store and Loader, a checkpoint, the census, a migrate extract, a
    tier demote, and a daemon with the sampler, the tier and the reshard
    plane armed."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", STATE_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "STATE-ISOLATED-OK" in proc.stdout


def test_only_the_device_boundary_pins_memory_or_makes_events():
    """Every crossing of the port's engines goes through runtime/place.py:
    outside it (and the command-line tools in cli/), no module of the port
    pins host memory or constructs a CUDA event."""
    pkg = REPO / "gubernator_tpu_torch"
    boundary = pkg / "runtime" / "place.py"
    marks = ("pin_memory", "torch.cuda.Event(")
    text = boundary.read_text()
    assert all(m in text for m in marks)
    found = [
        f"{path.relative_to(REPO)}:{i}"
        for path in sorted(pkg.rglob("*.py"))
        if path != boundary and path.relative_to(pkg).parts[0] != "cli"
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if any(m in line for m in marks)
    ]
    assert not found, found
