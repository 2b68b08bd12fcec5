"""The port's compiled fast lane (gubernator_tpu_torch/runtime/fastpath.py)
against the JAX package's, on the CPU.

The same raw GetRateLimits payloads, on the same frozen clock, go through
`FastPath.check_raw` of a port service and of a JAX service (its planes
off): the response BYTES are equal in the classic, pipelined, ring and
megaround serve modes, and so are the final tables.  The stream mixes
token and leaky keys, duplicate-heavy batches (the host-cascade merge),
sketch-tier names, single-node GLOBAL keys, Gregorian durations (valid and
invalid) and invalid lanes, as tests/test_differential.py:333,431 do for
the reference.  Persistent mode degrades to megaround on the CPU in both
packages."""
from __future__ import annotations

import asyncio
import random

import numpy as np
import pytest
import torch

from gubernator_tpu.core import config as jcfg
from gubernator_tpu.proto import gubernator_pb2 as jpb
from gubernator_tpu.runtime.fastpath import FastPath as JaxFastPath
from gubernator_tpu.runtime.service import ApiError as JaxApiError
from gubernator_tpu.runtime.service import Service as JaxService
from gubernator_tpu_torch import native
from gubernator_tpu_torch.core.config import (
    MAX_BATCH_SIZE,
    Config,
    DeviceConfig,
    SketchTierConfig,
)
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.runtime.fastpath import FastPath
from gubernator_tpu_torch.runtime.service import ApiError, Service

GLOBAL, RESET, GREG = 2, 8, 4
SLOTS, WAYS, B = 1024, 8, 64
SKETCH = dict(names=["sk"], width=1024, window_ms=1000, batch_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_service(clock) -> Service:
    return Service(Config(
        device=DeviceConfig(num_slots=SLOTS, ways=WAYS, batch_size=B,
                            platform="cpu"),
        sketch=SketchTierConfig(**SKETCH)), clock=clock)


def jax_service(clock) -> JaxService:
    """The reference service with every plane the port lacks turned off."""
    return JaxService(jcfg.Config(
        device=jcfg.DeviceConfig(num_slots=SLOTS, ways=WAYS, batch_size=B),
        sketch=jcfg.SketchTierConfig(**SKETCH),
        reshard=jcfg.ReshardConfig(enabled=False),
        stats=jcfg.StatsConfig(enabled=False),
    ), clock=clock)


def payload_stream(seed: int, n: int):
    """GetRateLimitsReq payloads.  GLOBAL keys keep per-key constant
    params and plain behavior (a flush-time re-read must be a no-op under
    the frozen clock); everything else churns."""
    rng = random.Random(seed)
    out = []
    for p in range(n):
        reqs = []
        hot = rng.random() < 0.3  # duplicate-heavy: the cascade merge
        for _ in range(rng.randrange(1, 30)):
            u = rng.random()
            if u < 0.12:
                k = rng.randrange(4)
                reqs.append(pb.RateLimitReq(
                    name="glob", unique_key=f"g{k}", hits=rng.choice([0, 1, 2]),
                    limit=20 + 10 * (k % 2), duration=60_000,
                    algorithm=k % 2, behavior=GLOBAL))
                continue
            if u < 0.25:
                reqs.append(pb.RateLimitReq(
                    name="sk", unique_key=f"s{rng.randrange(20)}",
                    hits=rng.choice([1, 2]), limit=6, duration=1000,
                    behavior=rng.choice([0, GLOBAL])))
                continue
            behavior, duration = 0, rng.choice([60_000, 60_000, 1_000])
            if rng.random() < 0.08:
                behavior |= RESET
            if rng.random() < 0.06:
                behavior |= GREG
                duration = rng.choice([0, 1, 2, 3, 4, 7])  # 3, 7 fail
            name, key = "fp", f"k{rng.randrange(3 if hot else 12)}"
            if rng.random() < 0.03:
                key = ""
            elif rng.random() < 0.03:
                name = ""
            reqs.append(pb.RateLimitReq(
                name=name, unique_key=key,
                hits=rng.choice([1, 1, 2, 3] if hot else [0, 1, 1, 2, -1]),
                limit=rng.choice([10, 30]) if not hot else 30,
                duration=60_000 if hot else duration,
                algorithm=(p % 2) if hot else rng.choice([0, 1]),
                behavior=0 if hot else behavior,
                burst=0 if hot else rng.choice([0, 0, 25])))
        out.append(pb.GetRateLimitsReq(requests=reqs).SerializeToString())
    return out


async def serve_stream(svc, fp, payloads, clock):
    await svc.start()
    got = []
    for i, p in enumerate(payloads):
        got.append(await fp.check_raw(p, peer_rpc=False))
        if i % 5 == 4:
            clock.advance(700)  # the sketch window rolls now and then
    return got


def run_pair(mode: str, clock, payloads):
    """Both services, both lanes, one mode; returns (port bytes, jax bytes,
    port fast lane, port table, jax table)."""
    t0 = clock.now_ns()

    async def port():
        svc = port_service(clock)
        fp = FastPath(svc, serve_mode=mode, ring_slots=2, ring_rounds=2)
        try:
            return await serve_stream(svc, fp, payloads, clock), fp, \
                svc.backend.snapshot()
        finally:
            await fp.close()
            await svc.close()

    async def ref():
        svc = jax_service(clock)
        fp = JaxFastPath(svc, serve_mode=mode, ring_slots=2, ring_rounds=2)
        try:
            return await serve_stream(svc, fp, payloads, clock), fp, \
                svc.backend.snapshot()
        finally:
            await fp.close()
            await svc.close()

    got, fp, table = asyncio.run(asyncio.wait_for(port(), 60))
    clock.freeze(t0)
    want, jfp, jtable = asyncio.run(asyncio.wait_for(ref(), 60))
    return got, want, fp, jfp, table, jtable


@pytest.mark.parametrize("mode", ["classic", "pipelined", "ring",
                                  "megaround"])
def test_raw_bytes_match_jax_lane(mode, frozen_clock):
    if not native.available():
        pytest.fail("the port's native library did not build")
    payloads = payload_stream(len(mode), 24)
    got, want, fp, jfp, table, jtable = run_pair(mode, frozen_clock,
                                                 payloads)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None and g == w, f"payload {i}"
    for f in jtable:
        np.testing.assert_array_equal(table[f], jtable[f], err_msg=f)
    assert fp.effective_serve_mode == jfp.effective_serve_mode == mode
    assert fp.fallbacks == 0 and fp.served == jfp.served > 0
    if mode in ("ring", "megaround"):
        assert sum(fp.blocking_fetches.values()) == 0
        assert fp._ring.seq_mismatches == 0


def test_persistent_degrades_to_megaround_in_both(frozen_clock):
    payloads = payload_stream(5, 10)
    got, want, fp, jfp, table, jtable = run_pair("persistent", frozen_clock,
                                                 payloads)
    assert got == want
    assert fp.effective_serve_mode == jfp.effective_serve_mode == "megaround"
    assert fp.persistent_status["supported"] is False
    assert jfp.persistent_status["supported"] is False
    for f in jtable:
        np.testing.assert_array_equal(table[f], jtable[f], err_msg=f)


def test_concurrent_pipelined_merges_match_classic(frozen_clock):
    """Concurrent RPCs coalesce into shared merges on the pipelined lane:
    with disjoint key spaces per worker the responses equal the strict
    depth-1 classic lane's, and the JAX classic lane's."""
    rng = random.Random(3)
    workers = []
    for w in range(4):
        ps = []
        for _ in range(8):
            ps.append(pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
                name=f"w{w}", unique_key=f"k{rng.randrange(5)}",
                hits=rng.choice([0, 1, 2, 3]), limit=20, duration=60_000,
                algorithm=rng.choice([0, 1]))
                for _ in range(rng.randrange(1, 10))]).SerializeToString())
        workers.append(ps)

    def run(make_svc, make_fp):
        async def scenario():
            svc = make_svc(frozen_clock)
            await svc.start()
            fp = make_fp(svc)
            out = {}

            async def worker(w):
                await asyncio.sleep(w * 0.002)
                out[w] = [await fp.check_raw(p, peer_rpc=False)
                          for p in workers[w]]

            await asyncio.gather(*(worker(w) for w in range(4)))
            drains = fp._mach.drains
            await fp.close()
            await svc.close()
            return out, drains

        return asyncio.run(asyncio.wait_for(scenario(), 60))

    deep, drains = run(port_service,
                       lambda s: FastPath(s, pipeline_depth=3))
    base, _ = run(port_service,
                  lambda s: FastPath(s, serve_mode="classic"))
    ref, _ = run(jax_service,
                 lambda s: JaxFastPath(s, serve_mode="classic"))
    assert deep == base == ref
    assert drains >= 2


def test_peer_rpc_and_oversized_batches_match_jax(frozen_clock):
    """The peer RPC (owner side: GLOBAL lanes queue broadcast updates,
    validation errors answer inline) gives the JAX lane's bytes; an
    oversized batch raises the same ApiError on both lanes."""
    payloads = payload_stream(9, 6)

    async def go(make_svc, make_fp, big):
        svc = make_svc(frozen_clock)
        await svc.start()
        fp = make_fp(svc)
        try:
            out = [await fp.check_raw(p, peer_rpc=True) for p in payloads]
            errs = []
            for peer in (False, True):
                try:
                    await fp.check_raw(big, peer_rpc=peer)
                except (ApiError, JaxApiError) as e:
                    errs.append((e.code, str(e)))
            return out, errs
        finally:
            await fp.close()
            await svc.close()

    big = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
        name="n", unique_key=f"k{i}", hits=1, limit=5, duration=1000)
        for i in range(MAX_BATCH_SIZE + 1)]).SerializeToString()
    got, errs = asyncio.run(go(port_service, FastPath, big))
    want, jerrs = asyncio.run(go(jax_service, JaxFastPath, big))
    assert got == want
    assert errs == jerrs and len(errs) == 2
    assert all(code == "OUT_OF_RANGE" for code, _ in errs)
    assert jpb.GetRateLimitsResp.FromString(got[0]).responses
