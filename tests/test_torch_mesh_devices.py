"""The port's mesh across devices (gubernator_tpu_torch/parallel/): the
placement rule, each shard's own table, claim words and stream, the results
left on the shards' devices, and the collective GLOBAL sync as copies
between the shards, on the CPU against the JAX package's 4-device mesh on
conftest's virtual CPU devices.

The port's shards are placed with `devices=[cpu] * 4`, so every shard owns
its storage, as each device of the JAX mesh does.  A seeded stream (numpy)
of token and leaky requests (2:1) with duplicate keys, RESET_REMAINING and
Gregorian durations; the ring and megaround dispatches, fetched and not; a
checkpoint crossing each way; three psum and three a2a engine ticks; and a
GUBER_MESH_WAYS=4 daemon's /debug/vars.  Every comparison is exact.

Two tests need the card, and skip here: one dispatch over four shard
streams of one card against the plain `ring_step`, and (with two cards or
more) K1 and K2 launched on card 1 leaving the caller's current device as
it was.  The JAX package is imported inside the tests that compare with
it, so these run alone on the card's machine:
    python -m pytest --noconftest -m cuda tests/test_torch_mesh_devices.py
"""
from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.ops.kernels import serve_kernel
from gubernator_tpu_torch.parallel.mesh import ShardedTensor, make_mesh
from gubernator_tpu_torch.parallel.sharded import (
    MeshBackend,
    fetch_sharded,
    pack_requests_sharded,
)
from gubernator_tpu_torch.runtime.place import carry

SLOTS, WAYS, B, N = 1 << 12, 8, 32, 4
CPU = torch.device("cpu")
GLOBAL, RESET, GREGORIAN = 2, 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(clock, slots=SLOTS, **kw):
    """(the port's mesh, one shard on each of 4 CPU devices; the JAX mesh
    on 4 virtual CPU devices) of one geometry."""
    from gubernator_tpu.core.config import DeviceConfig as JaxDeviceConfig
    from gubernator_tpu.parallel.sharded import MeshBackend as JaxMesh

    geo = dict(num_slots=slots, ways=WAYS, batch_size=B, num_shards=N)
    return (MeshBackend(DeviceConfig(platform="cpu", **geo), clock=clock,
                        devices=[CPU] * N, **kw),
            JaxMesh(JaxDeviceConfig(**geo), clock=clock, **kw))


def stream(rng: np.random.Generator, count: int, n_keys: int = 60,
           behavior: int = 0):
    """Request fields: token and leaky 2:1 by key, duplicates (a small key
    space), 5% RESET_REMAINING, 10% Gregorian (minute/hour/day)."""
    out = []
    for _ in range(count):
        k = int(rng.integers(n_keys))
        beh = behavior
        if rng.random() < 0.05:
            beh |= RESET
        greg = rng.random() < 0.10
        if greg:
            beh |= GREGORIAN
        out.append(dict(
            name=f"m{k % 3}", unique_key=f"k{k}",
            hits=int(rng.choice([0, 1, 1, 2, 5])),
            limit=int(rng.choice([1, 10, 100])),
            duration=int(rng.integers(3)) if greg
            else int(rng.choice([1000, 60_000])),
            algorithm=int(k % 3 == 2), behavior=beh,
            burst=int(rng.choice([0, 0, 20]))))
    return out


def reqs_of(fields, port: bool):
    if port:
        from gubernator_tpu_torch.core.types import RateLimitReq
    else:
        from gubernator_tpu.core.types import RateLimitReq
    return [RateLimitReq(**f) for f in fields]


def resp_key(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


def assert_snapshot_is_table_to_host(pb, jb, ctx=""):
    from gubernator_tpu.ops.state import table_to_host

    got, want = pb.snapshot(), table_to_host(jb.table)
    assert set(got) == set(want)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{ctx} {f}")


def test_placement_wraps_devices_and_each_shard_owns_its_storage():
    """Shard s on devices[s % len(devices)]; every shard's table and
    stream its own; the CPU default places every shard on the CPU; a mesh
    asked for a card without one raises."""
    assert make_mesh(4, "cpu", devices=[CPU, CPU]) == [CPU] * 4
    assert make_mesh(5, "cpu") == [CPU] * 5
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")
    be = MeshBackend(DeviceConfig(num_slots=SLOTS, ways=WAYS, batch_size=B,
                                  num_shards=N, platform="cpu"),
                     devices=[CPU, CPU])
    assert be.shard_devices == ["cpu"] * N
    assert len(be.tables) == N and be.claims == [None] * N
    spans = sorted((t.key.data_ptr(), t.key.data_ptr() + 8 * len(t.key))
                   for t in be.tables)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert all(len(t.key) == SLOTS // N for t in be.tables)
    assert all(p.stream is None for p in be.shards)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(4, "cuda")


@pytest.mark.parametrize("seed", [1, 2])
def test_seeded_stream_matches_jax_mesh(seed, frozen_clock):
    """Every response, and snapshot() against the JAX table_to_host after
    every call."""
    pb, jb = pair(frozen_clock)
    rng = np.random.default_rng(seed)
    for step in range(25):
        fields = stream(rng, int(rng.integers(1, 120)))
        got = pb.check(reqs_of(fields, True))
        want = jb.check(reqs_of(fields, False))
        assert [resp_key(r) for r in got] == [resp_key(r) for r in want], \
            step
        assert_snapshot_is_table_to_host(pb, jb, f"step {step}")
        frozen_clock.advance(int(rng.choice([0, 0, 300, 5_000])))
    assert pb.shard_occupancy() == jb.shard_occupancy()


def test_ring_and_megaround_match_jax_mesh(frozen_clock):
    """ring_step_dispatch and ring_mega_dispatch, their results read
    unfetched and through the per-shard fetch (the ring runner's form):
    responses, sequence words and tables equal the JAX mesh's."""
    pb, jb = pair(frozen_clock)
    rng = np.random.default_rng(4)
    now = frozen_clock.millisecond_now()
    seq_p, seq_j = pb.ring_seq_init(), jb.ring_seq_init()
    for it in range(6):
        packed = pack_requests_sharded(
            reqs_of(stream(rng, 150), True), B, N, frozen_clock)
        rounds = (packed.rounds + [packed.rounds[-1]._replace(
            active=np.zeros_like(packed.rounds[-1].active))] * 4)[:4]
        qs = np.stack([pb.ring_pack_round(db, B) for db in rounds])
        nows = np.full(4, now + it, dtype=np.int64)
        fetch = it >= 3
        if it % 2:
            qs, nows = qs.reshape((2, 2) + qs.shape[1:]), nows.reshape(2, 2)
            rp, seq_p = pb.ring_mega_dispatch(qs, nows, seq_p, fetch=fetch)
            rj, seq_j = jb.ring_mega_dispatch(qs, nows, seq_j)
            rj = np.asarray(rj).reshape((4,) + rj.shape[2:]) if fetch else rj
        else:
            rp, seq_p = pb.ring_step_dispatch(qs, nows, seq_p, fetch=fetch)
            rj, seq_j = jb.ring_step_dispatch(qs, nows, seq_j)
        if fetch:
            rp, sp = rp.wait()
            np.testing.assert_array_equal(sp, np.asarray(seq_j))
        else:
            rp = rp.numpy()
        np.testing.assert_array_equal(rp, np.asarray(rj))
        np.testing.assert_array_equal(seq_p.numpy(), np.asarray(seq_j))
    assert seq_p.tolist() == [24] * N
    assert_snapshot_is_table_to_host(pb, jb)


def test_checkpoints_cross_both_ways(frozen_clock):
    """A JAX mesh's table restored into the port's mesh, and the port's
    into a JAX mesh; then the same traffic through all four keeps every
    answer and table equal."""
    from gubernator_tpu.ops.state import table_to_host

    pb, jb = pair(frozen_clock)
    rng = np.random.default_rng(7)
    fields = stream(rng, 200)
    pb.check(reqs_of(fields, True))
    jb.check(reqs_of(fields, False))
    pb2, jb2 = pair(frozen_clock)
    pb2._install_table(table_to_host(jb.table))
    jb2._install_table(pb.snapshot())
    frozen_clock.advance(700)
    more = stream(rng, 200)
    answers = [[resp_key(r) for r in b.check(reqs_of(more, port))]
               for b, port in ((pb, True), (jb, False), (pb2, True),
                               (jb2, False))]
    assert answers[0] == answers[1] == answers[2] == answers[3]
    for p, j in ((pb, jb2), (pb2, jb), (pb2, jb2)):
        assert_snapshot_is_table_to_host(p, j)


@pytest.mark.parametrize("collective", ["psum", "a2a"])
def test_engine_ticks_match_jax(collective, frozen_clock):
    """Three ticks of GLOBAL checks and a sync (source grids copied to
    each owner, merged, applied by K1's plain version, broadcast rows
    copied to every replica): answers, the auth table and the replicated
    cache equal the JAX engine's after every tick."""
    from gubernator_tpu.parallel.global_sync import GlobalEngine as JaxEngine
    from gubernator_tpu_torch.parallel.global_sync import GlobalEngine

    pb, jb = pair(frozen_clock)
    pe = GlobalEngine(pb, collective=collective, delta_slots=8)
    je = JaxEngine(jb, collective=collective, delta_slots=8)
    pe.warmup()
    je.warmup()
    rng = np.random.default_rng(11)
    for tick in range(3):
        fields = stream(rng, 90, n_keys=50, behavior=GLOBAL)
        got = pe.check(reqs_of(fields, True))
        want = je.check(reqs_of(fields, False))
        assert [resp_key(r) for r in got] == [resp_key(r) for r in want]
        assert pe.sync() == je.sync() > 0
        assert_snapshot_is_table_to_host(pb, jb, f"tick {tick}")
        for f in je.cache_table._fields:
            np.testing.assert_array_equal(
                getattr(pe.cache_table, f).numpy(),
                np.asarray(getattr(je.cache_table, f)),
                err_msg=f"tick {tick} cache {f}")
        frozen_clock.advance(400)
    assert pe.cache_occupancy() == je.cache_occupancy() > 0


def test_mesh_daemon_debug_vars_list_shard_devices(frozen_clock,
                                                   monkeypatch):
    """A GUBER_MESH_WAYS=4 CPU daemon lists its placement in /debug/vars
    `backend.shard_devices`, beside the per-shard occupancy."""
    import aiohttp
    from test_torch_daemon import call, free_ports

    from gubernator_tpu_torch.core.config import setup_daemon_config
    from gubernator_tpu_torch.daemon import Daemon
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    g, h = free_ports(2)
    for k, v in dict(GUBER_MESH_WAYS="4", GUBER_TPU_NUM_SLOTS=str(SLOTS),
                     GUBER_TPU_BATCH_SIZE=str(B), GUBER_TPU_PLATFORM="cpu",
                     GUBER_GRPC_ADDRESS=f"127.0.0.1:{g}",
                     GUBER_HTTP_ADDRESS=f"127.0.0.1:{h}",
                     GUBER_STATS_ENABLED="false").items():
        monkeypatch.setenv(k, v)
    payload = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
        name="dev", unique_key=f"k{i}", hits=1, limit=5, duration=60_000)
        for i in range(30)]).SerializeToString()

    async def scenario():
        d = Daemon(setup_daemon_config(), clock=frozen_clock)
        await d.start()
        try:
            await call(d.grpc_address, "GetRateLimits", payload)
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://{d.http_address}/debug/vars") as r:
                    return (await r.json())["backend"]
        finally:
            await d.close()

    be = asyncio.run(asyncio.wait_for(scenario(), 90))
    assert be["shard_devices"] == ["cpu"] * 4
    assert len(be["shard_occupancy"]) == 4
    assert sum(be["shard_occupancy"]) == be["occupancy"] >= 30


def test_sharded_results_assemble_on_the_host():
    """A ShardedTensor's parts stack on its axis, through numpy(), the
    per-shard fetch and unflatten; carry between CPU shards is the tensor
    itself."""
    parts = [torch.arange(6, dtype=torch.int64).reshape(3, 2) + 10 * s
             for s in range(N)]
    t = ShardedTensor(parts, [None] * N, 1)
    want = np.stack([p.numpy() for p in parts], axis=1)
    assert t.shape == want.shape == (3, N, 2)
    np.testing.assert_array_equal(t.numpy(), want)
    (got,) = fetch_sharded([t]).wait()
    np.testing.assert_array_equal(got, want)
    u = ShardedTensor([p.reshape(6) for p in parts], [None] * N, 1)
    np.testing.assert_array_equal(u.unflatten(0, (2, 3)).numpy(),
                                  np.stack([p.reshape(2, 3).numpy()
                                            for p in parts], axis=2))
    be = MeshBackend(DeviceConfig(num_slots=SLOTS, ways=WAYS, batch_size=B,
                                  num_shards=N, platform="cpu"))
    assert carry(parts[0], be.shards[0], be.shards[3]) is parts[0]


def _random_mesh(dev, n, S, rng, now, devices):
    """A MeshBackend of n shards on `devices` holding a seeded random
    table, with the per-shard host parts and key spaces."""
    from gubernator_tpu_torch.testing import KeySpace, random_table

    L = S // n
    spaces = [KeySpace(rng, L, WAYS, hot_buckets=16) for _ in range(n)]
    parts = [random_table(rng, ks, now) for ks in spaces]
    be = MeshBackend(DeviceConfig(num_slots=S, ways=WAYS, batch_size=2048,
                                  num_shards=n, platform=dev.type),
                     devices=devices)
    be._install_table({f: np.concatenate([p[f] for p in parts])
                       for f in parts[0]})
    return be, parts, spaces


@pytest.mark.cuda
def test_dispatch_over_four_streams_matches_plain_on_cuda():
    """One mesh dispatch on one card: 4 shards, 4 streams of their own,
    one K1 launch each; the responses, sequence words and each shard's
    table equal the plain ring_step on a copy of that shard, bit for bit,
    and every shard's claim words are back at INT32_MAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    from gubernator_tpu_torch.ops.ring import ring_step
    from gubernator_tpu_torch.ops.state import clone_table
    from gubernator_tpu_torch.testing import random_rounds

    dev = torch.device("cuda", 0)
    n, S, now, k = 4, 1 << 16, 1_700_000_000_000, 3
    rng = np.random.default_rng(12)
    be, parts, spaces = _random_mesh(dev, n, S, rng, now, [dev])
    assert be.shard_devices == ["cuda:0"] * n
    assert len({p.stream.cuda_stream for p in be.shards}) == n
    qs = np.stack([random_rounds(rng, spaces[s], parts[s]["key"], k, 2048,
                                 now) for s in range(n)], axis=2)
    nows = np.array([now, now + 5, now + 9], dtype=np.int64)
    be.synchronize()
    starts = [clone_table(t) for t in be.tables]
    torch.cuda.synchronize()
    launches = serve_kernel.launches
    resps, seq = be.ring_step_dispatch(qs, nows, be.ring_seq_init())
    got = resps.numpy()
    assert serve_kernel.launches == launches + n
    assert seq.tolist() == [k] * n
    for s in range(n):
        z = torch.zeros((), dtype=torch.int64, device=dev)
        _, pr, _ = ring_step(starts[s], torch.from_numpy(
            np.ascontiguousarray(qs[:, :, s])).to(dev),
            torch.from_numpy(nows).to(dev), z, WAYS)
        np.testing.assert_array_equal(got[:, s], pr.cpu().numpy())
    be.synchronize()
    for s in range(n):
        for x, y in zip(be.tables[s], starts[s]):
            if x.dtype == torch.float64:
                x, y = x.view(torch.int64), y.view(torch.int64)
            assert torch.equal(x, y), s
        assert bool((be.claims[s] == serve_kernel.INT32_MAX).all())


@pytest.mark.cuda
def test_launchers_keep_the_callers_device_on_cuda():
    """K1's and K2's entry points select the card they work on and give
    the calling thread its current device back: a K1 and a K2 launch on
    card 1 (and their shape queries) leave card 0 current."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from gubernator_tpu_torch.ops.kernels import cms_kernel
    from gubernator_tpu_torch.ops.sketch import init_sketch
    from gubernator_tpu_torch.ops.state import init_table

    one = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    serve_kernel.owners(one)
    serve_kernel.scratch_words(one, 2, 256)
    cms_kernel.cluster_blocks(one)
    assert torch.cuda.current_device() == 0
    table = init_table(1 << 12, one)
    qs = torch.zeros((2, 12, 256), dtype=torch.int64, device=one)
    qs[:, 0] = torch.arange(1, 257, device=one)
    qs[:, 1:4] = 1
    qs[:, 10] = 1
    nows = torch.full((2,), 1_700_000_000_000, dtype=torch.int64, device=one)
    seq = torch.zeros((), dtype=torch.int64, device=one)
    claim = serve_kernel.new_claim_buffer(1 << 12, one)
    torch.cuda.synchronize(one)
    serve_kernel.persistent_serve_step(table, qs, nows, seq, WAYS, claim)
    assert torch.cuda.current_device() == 0
    st = init_sketch(4, 1 << 10, 60_000, one)
    kh = torch.arange(1, 65, dtype=torch.int64, device=one).reshape(1, 64)
    hits = torch.ones((1, 64), dtype=torch.int32, device=one)
    cms_kernel.cms_multi_step(st, kh, hits, hits * 5, 1_700_000_000_000)
    assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(one)
    assert int((table.key != 0).sum()) == 256
