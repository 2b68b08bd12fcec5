"""Graft entry points: the single-device decision step and a mesh dry run.

The port of the repo-root __graft_entry__.py.

`entry(device)` returns the decision step (the framework's "forward pass":
one batched rate-limit decision step against the slot table) and example
arguments for it.  On the card the step is K1, the hand-written serve
kernel; on the CPU it is K1's plain version, which its wrapper takes for
tensors that lie on the CPU.

`dryrun_multichip(n, device)` builds an n-shard MeshBackend and runs the
JAX dry run's every step and assertion on it: two checks, the mesh ring
sweep against classic dispatches, the collective GLOBAL engine's ticks and
a mesh Service.  The JAX dry run shards the table over n devices; here the
n shards are contiguous slices of ONE table on ONE device
(parallel/mesh.py), so the dry run needs no virtual devices.

Both run on the CUDA card unless `device` (or GUBER_TPU_PLATFORM=cpu)
asks for the CPU.
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import torch

NOW = 1_700_000_000_000


def _device(device=None) -> torch.device:
    return torch.device(
        device or os.environ.get("GUBER_TPU_PLATFORM") or "cuda")


def decision_step(table, q: torch.Tensor, now: int, ways: int = 8,
                  claim: Optional[torch.Tensor] = None):
    """One packed round int64[12, B] through K1 at `now`; returns
    (table, int64[9, B] packed responses).  The table is updated in
    place."""
    from gubernator_tpu_torch.ops.kernels.serve_kernel import (
        persistent_serve_step,
    )

    dev = q.device
    nows = torch.full((1,), now, dtype=torch.int64, device=dev)
    seq = torch.zeros((), dtype=torch.int64, device=dev)
    table, resps, _ = persistent_serve_step(
        table, q.unsqueeze(0).contiguous(), nows, seq, ways, claim)
    return table, resps[0]


def entry(device=None):
    """(fn, example_args): fn(table, q, now) is the decision step of one
    round; the args are a 4096-slot table and 64 requests packed at 256
    lanes."""
    from gubernator_tpu_torch.core.types import RateLimitReq
    from gubernator_tpu_torch.ops.batch import pack_batch_q, pack_requests
    from gubernator_tpu_torch.ops.kernels.serve_kernel import (
        new_claim_buffer,
    )
    from gubernator_tpu_torch.ops.state import init_table

    dev = _device(device)
    table = init_table(4096, dev)
    reqs = [
        RateLimitReq(
            name="graft", unique_key=f"k{i}", hits=1, limit=100,
            duration=60_000,
        )
        for i in range(64)
    ]
    packed = pack_requests(reqs, 256)
    q = torch.from_numpy(pack_batch_q(packed.rounds[0])).to(dev)
    claim = new_claim_buffer(4096, dev) if dev.type == "cuda" else None
    fn = functools.partial(decision_step, ways=8, claim=claim)
    return fn, (table, q, NOW)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Build an n-shard mesh and run the JAX dry run's steps on it.  Shard
    s goes on visible card s % (card count), as MeshBackend places it by
    default; with device="cpu" every shard is on the CPU."""
    import numpy as np

    from gubernator_tpu_torch.core import clock as clock_mod
    from gubernator_tpu_torch.core.config import DeviceConfig
    from gubernator_tpu_torch.core.types import RateLimitReq, Status
    from gubernator_tpu_torch.parallel.sharded import MeshBackend

    dev = _device(device)
    cfg = DeviceConfig(
        num_slots=n_devices * 8 * 16,  # 16 buckets/shard, 8 ways
        ways=8,
        batch_size=32,
        num_shards=n_devices,
        platform=dev.type,
    )
    clock = clock_mod.Clock()
    clock.freeze()
    backend = MeshBackend(cfg, clock=clock)
    reqs = [
        RateLimitReq(
            name="dryrun", unique_key=f"k{i}", hits=1, limit=10,
            duration=60_000,
        )
        for i in range(48)
    ]
    resps = backend.check(reqs)
    assert all(r.error == "" for r in resps)
    assert all(r.status == Status.UNDER_LIMIT for r in resps)
    assert all(r.remaining == 9 for r in resps)
    # Second step over the same keys: state persisted and decremented.
    resps = backend.check(reqs)
    assert all(r.remaining == 8 for r in resps)

    # Mesh ring serve-mode sweep: the ring step drives the same grid
    # rounds through the ring runner and must be bit-identical to the
    # classic dispatch, with every shard's sequence word marching with
    # the host mirror and per-shard occupancy reported.
    from gubernator_tpu_torch.parallel.sharded import pack_requests_sharded
    from gubernator_tpu_torch.runtime.ring import RingBackend

    ring_be = MeshBackend(cfg, clock=clock)
    ring = RingBackend(ring_be, slots=4)
    classic_be = MeshBackend(cfg, clock=clock)
    try:
        for step in range(3):
            rreqs = [
                RateLimitReq(
                    name="dryring", unique_key=f"r{(step * 7 + i) % 19}",
                    hits=1, limit=10, duration=60_000,
                )
                for i in range(40)
            ]
            want = classic_be.step_rounds(
                pack_requests_sharded(
                    rreqs, cfg.batch_size, n_devices, clock
                ).rounds,
                add_tally=False,
            )
            got = ring.submit_rounds(
                pack_requests_sharded(
                    rreqs, cfg.batch_size, n_devices, clock
                ).rounds
            )()
            for wh, gh in zip(want, got):
                for col in ("status", "remaining", "reset_time"):
                    np.testing.assert_array_equal(
                        wh[col], gh[col][..., : wh[col].shape[-1]],
                        err_msg=col,
                    )
        assert ring.seq_mismatches == 0
        assert ring.seq_shards == [ring.seq] * n_devices, ring.seq_shards
        occ = ring_be.shard_occupancy()
        assert sum(occ) == ring_be.occupancy() > 0
        print(
            f"mesh ring sweep: {ring.iterations} iterations, seq "
            f"{ring.seq} consistent on all {n_devices} shards, 0 "
            f"mismatches; per-shard occupancy {occ}"
        )
    finally:
        ring.close()

    # GLOBAL collective path: replicated serving + ONE psum sync step
    # over the same mesh (parallel/global_sync.py).
    from gubernator_tpu_torch.core.types import Behavior
    from gubernator_tpu_torch.parallel.global_sync import GlobalEngine

    geng = GlobalEngine(backend)
    greqs = [
        RateLimitReq(
            name="dryg", unique_key=f"g{i}", hits=1, limit=100,
            duration=60_000, behavior=Behavior.GLOBAL,
        )
        for i in range(24)
    ]
    gresps = geng.check(greqs)
    assert all(r.error == "" for r in gresps)
    synced = geng.sync()
    assert synced > 0, "global sync step moved no keys"
    gresps = geng.check(greqs)
    assert all(r.error == "" for r in gresps)

    # Ingest -> collective sync -> verify ticks: after each sync the
    # replicated counters converge to the authoritative totals.  Entering
    # this loop the keys have 2 applied-or-pending hits each (the two
    # checks above, one sync applied the first).
    from dataclasses import replace as dc_replace

    reads = [dc_replace(r, hits=0) for r in greqs]
    for tick in range(1, 4):
        geng.check(greqs)            # +1 hit/key, arrival-sharded ingest
        moved = geng.sync()          # ONE psum -> owner -> all_gather
        assert moved == len(greqs), (tick, moved)
        rs = geng.check(reads)       # replicated read-back, no mutation
        want = 100 - 2 - tick
        assert all(r.remaining == want for r in rs), (
            tick, want, sorted({r.remaining for r in rs}),
        )
        print(
            f"engine tick {tick} ({geng.collective}): synced={moved} "
            f"keys, replicated remaining converged to {want} on all "
            "arrival devices"
        )

    # Service-level wiring: GLOBAL requests on a mesh service route
    # through the collective engine.
    import asyncio

    from gubernator_tpu_torch.core.config import BehaviorConfig, Config
    from gubernator_tpu_torch.runtime.service import Service

    async def _svc_path() -> None:
        svc = Service(
            Config(
                device=cfg,
                behaviors=BehaviorConfig(global_sync_wait_s=0.005),
            ),
            backend=backend,
            clock=clock,
        )
        await svc.start()
        assert svc.global_engine is not None, "mesh service missing engine"
        rs = await svc.get_rate_limits([
            RateLimitReq(
                name="drysvc", unique_key=f"s{i}", hits=1, limit=100,
                duration=60_000, behavior=Behavior.GLOBAL,
            )
            for i in range(16)
        ])
        assert all(r.error == "" for r in rs)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 60.0
        while svc.global_engine.syncs < 1:
            assert loop.time() < deadline, "collective sync never fired"
            await asyncio.sleep(0.01)
        await svc.close()

    asyncio.run(_svc_path())
    print(f"dryrun_multichip({n_devices}): OK — mesh of {n_devices} shards "
          f"x {backend.local_slots} slots on {backend.shard_devices}")
