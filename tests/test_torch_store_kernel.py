"""The store kernel, the GLOBAL replica upsert (ops/kernels/serve_kernel.py
`store_rows`, csrc/serve_kernel.cu `k1_store_kernel`), and its plain version
(ops/step.py `store_cached_rows`).

On CPU tensors the wrapper takes the plain path and counts no dispatch; its
callers (the GLOBAL engine's broadcast, TorchBackend's and MeshBackend's
`apply_cached_rows`) give the same tables as the plain op applied to the
same blocks.  On a CUDA card the kernel is held bit-exact against the plain
version on all 12 columns, with the claim words restored.  The file imports
no JAX, so the card's machine can run the kernel test alone:
    python -m pytest --noconftest -m cuda tests/test_torch_store_kernel.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gubernator_tpu_torch.core.clock import Clock
from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.core.hashing import bulk_key_hash64
from gubernator_tpu_torch.ops.kernels import serve_kernel
from gubernator_tpu_torch.ops.state import (
    clone_table,
    init_table,
    table_from_host,
)
from gubernator_tpu_torch.ops.step import (
    store_cached_rows,
    unpack_cached_rows,
)
from gubernator_tpu_torch.testing import (
    KeySpace,
    random_cached_block,
    random_table,
)

NOW = 1_700_000_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed: int, slots: int, lanes: int, hot: int = 8,
          crowd: int = 0):
    """(host table, int64[6, lanes] block): full hot buckets, empty ways,
    expired rows, cached rows, tied touch stamps; the block holds keys
    already in the table (own stale rows among them), fresh keys, inactive
    lanes with garbage, and `crowd` more fresh keys in one hot bucket than
    three claim rounds can place."""
    rng = np.random.default_rng(seed)
    ks = KeySpace(rng, slots, 8, hot_buckets=hot)
    host = random_table(rng, ks, NOW)
    block = random_cached_block(rng, ks, host["key"], lanes, NOW)
    if crowd:
        fresh = ks.in_bucket(np.full(crowd, ks.hot[0]))
        block[0, rng.choice(lanes, crowd, replace=False)] = fresh
        _, first = np.unique(block[0], return_index=True)
        dup = np.ones(lanes, dtype=bool)
        dup[first] = False
        block[0, dup] = 0  # keys stay unique within the block
    return host, block


def _same(a, b) -> bool:
    for x, y in zip(a, b):
        if x.dtype == torch.float64:  # compare the float column as bits
            x, y = x.view(torch.int64), y.view(torch.int64)
        if not torch.equal(x, y):
            return False
    return True


@pytest.mark.parametrize("seed,slots,lanes", [(0, 1 << 13, 128),
                                              (1, 1 << 14, 1024)])
def test_wrapper_takes_plain_path_on_cpu(seed, slots, lanes):
    host, block = _case(seed, slots, lanes, crowd=12)
    rows = torch.from_numpy(block)
    a, b = table_from_host(host, "cpu"), table_from_host(host, "cpu")
    before = serve_kernel.store_launches
    a = serve_kernel.store_rows(a, rows, NOW, 8)
    b = store_cached_rows(b, unpack_cached_rows(rows), NOW, 8)
    assert serve_kernel.store_launches == before  # no kernel ran
    assert _same(a, b)
    # The case reaches drops: an active lane whose key is nowhere after.
    active = rows[0] != 0
    assert int((active & ~torch.isin(rows[0], a.key)).sum()) > 0


def test_wrapper_rejects_bad_inputs():
    host, block = _case(2, 1 << 13, 128)
    t = table_from_host(host, "cpu")
    rows = torch.from_numpy(block)
    with pytest.raises(TypeError, match="rows"):
        serve_kernel.store_rows(t, rows.to(torch.int32), NOW)
    with pytest.raises(ValueError, match="rows"):
        serve_kernel.store_rows(t, rows[:5], NOW)
    with pytest.raises(ValueError, match="contiguous"):
        serve_kernel.store_rows(t, rows.t().contiguous().t(), NOW)
    with pytest.raises(ValueError, match="claim"):
        serve_kernel.store_rows(t, rows, NOW, claim=serve_kernel
                                .new_claim_buffer(1 << 12, "cpu"))
    with pytest.raises(TypeError, match="claim"):
        serve_kernel.store_rows(t, rows, NOW, claim=torch.zeros(
            1 << 13, dtype=torch.int64))
    bad = t._replace(status=t.status.to(torch.int64))
    with pytest.raises(TypeError, match="status"):
        serve_kernel.store_rows(bad, rows, NOW)
    with pytest.raises(ValueError, match="power of two"):
        serve_kernel.store_rows(init_table(24, "cpu"), rows, NOW)


def test_backends_apply_cached_rows_through_the_wrapper():
    """TorchBackend (chunks of batch_size) and a 4-shard MeshBackend leave
    the tables the plain op leaves on the same blocks."""
    from gubernator_tpu_torch.parallel.mesh import shard_of_hash
    from gubernator_tpu_torch.parallel.sharded import MeshBackend
    from gubernator_tpu_torch.runtime.backend import TorchBackend

    clock = Clock()
    clock.freeze(NOW * 10**6)
    rng = np.random.default_rng(4)
    rows = [(f"g_k{j}", int(rng.integers(0, 2)), int(rng.integers(1, 100)),
             int(rng.integers(0, 100)), int(rng.integers(0, 2)),
             NOW + int(rng.integers(-5_000, 60_000))) for j in range(300)]
    h = bulk_key_hash64([r[0] for r in rows])
    cols = np.array([r[1:] for r in rows], dtype=np.int64).T
    block = torch.from_numpy(np.concatenate([h[None], cols]))

    be = TorchBackend(DeviceConfig(num_slots=1 << 12, ways=8, batch_size=128,
                                   platform="cpu"), clock=clock)
    be.apply_cached_rows(rows)
    want = init_table(1 << 12, "cpu")
    for lo in range(0, len(rows), 128):
        want = store_cached_rows(want, unpack_cached_rows(
            block[:, lo:lo + 128].contiguous()), NOW, 8)
    assert _same(be.table, want)

    mb = MeshBackend(DeviceConfig(num_slots=1 << 12, ways=8, batch_size=128,
                                  num_shards=4, platform="cpu"), clock=clock)
    mb.apply_cached_rows(rows)
    owner = shard_of_hash(h, 4)
    for s, got in enumerate(mb.tables):
        want = store_cached_rows(init_table(1 << 10, "cpu"),
                                 unpack_cached_rows(block[:, owner == s]),
                                 NOW, 8)
        assert _same(got, want), s


def test_global_broadcast_counts_rows_and_dispatches():
    """`global.broadcast` counts the rows offered to the replicas (keys x
    replicas) and the store dispatches (none on the CPU)."""
    from torch.profiler import ProfilerActivity, profile

    from gubernator_tpu_torch.core.types import RateLimitReq
    from gubernator_tpu_torch.parallel.global_sync import GlobalEngine
    from gubernator_tpu_torch.parallel.sharded import MeshBackend
    from gubernator_tpu_torch.runtime import tracing

    clock = Clock()
    clock.freeze(NOW * 10**6)
    eng = GlobalEngine(MeshBackend(DeviceConfig(
        num_slots=1 << 12, ways=8, batch_size=64, num_shards=4,
        platform="cpu"), clock=clock), delta_slots=16)
    reqs = [RateLimitReq(name="g", unique_key=f"k{j}", hits=1, limit=10,
                         duration=60_000, behavior=2) for j in range(90)]
    eng.check(reqs)
    with profile(activities=[ProfilerActivity.CPU]):
        assert eng.sync() == 90
    recs = [r for r in tracing.stage_records()
            if r[0] == "global.broadcast"]
    assert len(recs) >= 2  # 90 keys over 4 owners of 16 lanes: chunks
    assert sum(r[4]["rows"] for r in recs) == 90 * 4
    assert all(r[4]["launches"] == 0 for r in recs)


@pytest.mark.cuda
def test_store_kernel_matches_plain_on_cuda():
    """Bit-exact on all 12 columns, claim words restored, one dispatch a
    call: tables of 2^13-2^16 slots, L = 128, 1024 and 32768 (at 2^13
    slots most of the 32768 lanes find no slot), a crowded bucket, and an
    all-inactive block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    # (seed, slots, lanes, hot buckets, crowd)
    cases = [(10, 1 << 13, 128, 4, 12), (11, 1 << 14, 1024, 16, 20),
             (12, 1 << 16, 1024, 64, 0), (13, 1 << 16, 32768, 256, 40),
             (14, 1 << 13, 32768, 32, 0), (15, 1 << 15, 1024, 16, 0)]
    for n, (seed, slots, lanes, hot, crowd) in enumerate(cases):
        host, block = _case(seed, slots, lanes, hot, crowd)
        if n == len(cases) - 1:
            block[0] = 0  # every lane inactive: nothing changes
        rows = torch.from_numpy(block).to(dev)
        kt = table_from_host(host, dev)
        pt = clone_table(kt)
        claim = serve_kernel.new_claim_buffer(slots, dev)
        if n == 0:
            with pytest.raises(ValueError, match="claim"):
                serve_kernel.store_rows(kt, rows, NOW, 8)
            with pytest.raises(TypeError, match="now"):
                serve_kernel.store_rows(kt, rows, torch.tensor(NOW, device=dev),
                                        8, claim)
        before = serve_kernel.store_launches
        serve_kernel.store_rows(kt, rows, NOW, 8, claim)
        store_cached_rows(pt, unpack_cached_rows(rows), NOW, 8)
        torch.cuda.synchronize()
        assert serve_kernel.store_launches == before + 1, n
        assert _same(kt, pt), n
        assert bool((claim == serve_kernel.INT32_MAX).all()), n
        active = rows[0] != 0
        if crowd:  # lanes that lost every claim round were dropped
            assert int((active & ~torch.isin(rows[0], kt.key)).sum()) > 0, n
        if n == len(cases) - 1:
            assert _same(kt, table_from_host(host, dev))


@pytest.mark.cuda
def test_global_broadcast_waits_on_nothing_on_cuda():
    """The GLOBAL sync's broadcast on the card: no op from the all_gather
    on makes the host wait (torch's sync debug mode raises on any), one
    store dispatch a replica, counted with the rows offered in the
    `global.broadcast` stage, and the replicas and auth shards end as a
    CPU engine's on the same calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    from torch.profiler import ProfilerActivity, profile

    from gubernator_tpu_torch.core.types import RateLimitReq
    from gubernator_tpu_torch.parallel.global_sync import GlobalEngine
    from gubernator_tpu_torch.parallel.sharded import MeshBackend
    from gubernator_tpu_torch.runtime import tracing

    clock = Clock()
    rng = np.random.default_rng(21)
    engs = [GlobalEngine(MeshBackend(DeviceConfig(
        num_slots=1 << 14, ways=8, batch_size=1024, num_shards=4,
        global_cache_slots=1 << 13, platform=p), clock=clock))
        for p in ("cuda", "cpu")]
    gpu = engs[0]
    gather = gpu._all_gather

    def strict_gather(rows):
        torch.cuda.set_sync_debug_mode("error")
        return gather(rows)

    gpu._all_gather = strict_gather
    for step in range(4):
        clock.freeze((NOW + 40 * step) * 10**6)
        ids = rng.integers(0, 400, 300)
        reqs = [RateLimitReq(name="g", unique_key=f"k{j}", hits=int(j % 3),
                             limit=5 + int(j % 7), duration=60_000,
                             algorithm=int(j % 2), behavior=2) for j in ids]
        got, want = (e.check(reqs) for e in engs)
        assert [(r.status, r.remaining, r.reset_time) for r in got] == \
            [(r.status, r.remaining, r.reset_time) for r in want], step
        before = serve_kernel.store_launches
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                synced = gpu.sync()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert synced == engs[1].sync() > 0
        assert serve_kernel.store_launches == before + 4, step
        recs = [r[4] for r in tracing.stage_records()
                if r[0] == "global.broadcast"]
        assert recs == [{"rows": 4 * synced, "launches": 4}], step
    torch.cuda.synchronize()
    assert _same(gpu.cache_table, engs[1].cache_table)
    assert _same(gpu.b.table, engs[1].b.table)
    assert all(bool((c == serve_kernel.INT32_MAX).all())
               for c in gpu.cache_claims)
