"""Service-level micro-benchmark suite (reference benchmark_test.go:29-148).

Scenarios, each against an in-process daemon pair over real gRPC:
  peer_rpc       — direct GetPeerRateLimits, NO_BATCHING analog
  get_ratelimits — client GetRateLimits, owner-local keys
  global         — GLOBAL behavior reads on a non-owner
  sketch         — approximate-tier (CMS) checks on a sketch-named limit
  healthcheck    — HealthCheck RPC
  herd           — 100-way concurrent fan-out on one key (thundering herd)

Reports throughput and p50/p99 latency per scenario as JSON lines.
The port of gubernator_tpu/cli/microbench.py:

    python -m gubernator_tpu_torch.cli.microbench [--recompile-audit]

The daemons run on the CUDA card (exact checks through K1, the sketch
scenario through K2) unless GUBER_TPU_PLATFORM=cpu asks for the CPU (the
host-path numbers).

Reading the numbers: client + both daemons share ONE python process here,
so per-RPC latency is dominated by the grpc/asyncio floor (compare the
healthcheck scenario, which does no device work at all).  Device-path
throughput comes from batched calls — a single daemon sustains
~500 RPC/s x 1000-check batches through this frontend (vs the reference's
~2k single-check requests/s per node, README.md:94-100), and cli/bench.py
measures the raw device ceiling.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import time
from typing import Callable, List

import numpy as np

from gubernator_tpu_torch.client import AsyncV1Client
from gubernator_tpu_torch.core.config import (
    DaemonConfig,
    DeviceConfig,
    SketchTierConfig,
    fast_test_behaviors,
)
from gubernator_tpu_torch.core.types import Behavior, PeerInfo, RateLimitReq
from gubernator_tpu_torch.daemon import Daemon, wait_for_connect
from gubernator_tpu_torch.net.grpc_api import PeersV1Stub, req_to_pb
from gubernator_tpu_torch.proto import peers_pb2


async def timed(fn: Callable, seconds: float, concurrency: int):
    lat: List[float] = []
    stop = time.monotonic() + seconds

    async def worker():
        while time.monotonic() < stop:
            t0 = time.monotonic()
            await fn()
            lat.append(time.monotonic() - t0)

    await asyncio.gather(*(worker() for _ in range(concurrency)))
    arr = np.array(lat)
    return {
        "ops": len(lat),
        "ops_per_sec": round(len(lat) / seconds, 1),
        "p50_ms": round(float(np.percentile(arr, 50)) * 1e3, 3),
        "p99_ms": round(float(np.percentile(arr, 99)) * 1e3, 3),
    }


def kernel_audit() -> dict:
    """Per hand-written kernel: whether ops/kernels/build.py built (or
    found built) and loaded its library in this process (1 or 0), and its
    launches (dispatches) so far.  build.py loads each library once per
    process by construction, whatever shapes the kernel is launched at:
    nothing is compiled per shape inside the serving window, the storm the
    JAX package's jit-cache audit watches for."""
    from gubernator_tpu_torch.ops.kernels import build, cms_kernel, serve_kernel

    return {
        name: {"builds": int(name in build._loaded),
               "launches": mod.launches}
        for name, mod in (("serve_kernel", serve_kernel),
                          ("cms_kernel", cms_kernel))
    }


async def run(args) -> List[dict]:
    """Run every scenario; prints each line and returns them."""
    lines: List[dict] = []

    def say(line: dict) -> None:
        lines.append(line)
        print(json.dumps(line), flush=True)

    daemons = []
    for _ in range(2):
        d = Daemon(
            DaemonConfig(
                grpc_listen_address="127.0.0.1:0",
                http_listen_address="127.0.0.1:0",
                behaviors=fast_test_behaviors(),
                device=DeviceConfig(
                    num_slots=args.slots, batch_size=args.batch,
                    platform=os.environ.get("GUBER_TPU_PLATFORM") or None,
                ),
                sketch=SketchTierConfig(
                    names=["bench_sketch"], width=1 << 16,
                    window_ms=60_000, batch_size=args.batch,
                ),
            )
        )
        await d.start()
        d.conf.advertise_address = d.grpc_address
        daemons.append(d)
    peers = [PeerInfo(grpc_address=d.grpc_address) for d in daemons]
    for d in daemons:
        await d.set_peers(peers)
    await wait_for_connect([d.grpc_address for d in daemons])

    import grpc.aio

    client = AsyncV1Client(daemons[0].grpc_address)
    ch = grpc.aio.insecure_channel(daemons[0].grpc_address)
    peers_stub = PeersV1Stub(ch)

    # A key owned by daemon 0 (so "local") and one owned by daemon 1.
    # Ownership depends on the FULL hash key, so each scenario's name
    # needs its own lookup (a key local under "bench" may be remote
    # under "bench_sketch").
    def owned_by(d, name):
        i = 0
        while True:
            key = f"bench_k{i}"
            peer = daemons[0].service.get_peer(f"{name}_{key}")
            if peer.info().grpc_address == d.grpc_address:
                return key
            i += 1

    local_key = owned_by(daemons[0], "bench")
    remote_key = owned_by(daemons[1], "bench")
    sketch_key = owned_by(daemons[0], "bench_sketch")

    async def peer_rpc():
        await peers_stub.GetPeerRateLimits(
            peers_pb2.GetPeerRateLimitsReq(requests=[
                req_to_pb(RateLimitReq(
                    name="bench", unique_key=local_key, hits=1,
                    limit=1_000_000_000, duration=60_000,
                ))
            ])
        )

    async def get_ratelimits():
        await client.get_rate_limits([
            RateLimitReq(name="bench", unique_key=local_key, hits=1,
                         limit=1_000_000_000, duration=60_000)
        ])

    async def global_read():
        await client.get_rate_limits([
            RateLimitReq(name="bench", unique_key=remote_key, hits=1,
                         limit=1_000_000_000, duration=60_000,
                         behavior=Behavior.GLOBAL)
        ])

    async def sketch():
        await client.get_rate_limits([
            RateLimitReq(name="bench_sketch", unique_key=sketch_key, hits=1,
                         limit=1_000_000_000, duration=60_000)
        ])

    async def healthcheck():
        await client.health_check()

    async def herd():
        await asyncio.gather(*(
            client.get_rate_limits([
                RateLimitReq(name="bench", unique_key=local_key, hits=1,
                             limit=1_000_000_000, duration=60_000)
            ])
            for _ in range(100)
        ))

    scenarios = {
        "peer_rpc": (peer_rpc, args.concurrency),
        "get_ratelimits": (get_ratelimits, args.concurrency),
        "global": (global_read, args.concurrency),
        "sketch": (sketch, args.concurrency),
        "healthcheck": (healthcheck, args.concurrency),
        "herd_100way": (herd, 1),
    }
    for name, (fn, conc) in scenarios.items():
        stats = await timed(fn, args.seconds, conc)
        say({"scenario": name, **stats})

    if args.recompile_audit:
        # After the canonical workload above: each kernel's builds and
        # launches in this process.
        say({"scenario": "recompile_audit", "kernels": kernel_audit()})

    await client.close()
    await ch.close()
    for d in daemons:
        await d.close()
    return lines


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--concurrency", type=int, default=16)
    p.add_argument("--slots", type=int, default=65_536)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument(
        "--recompile-audit", action="store_true",
        help="after the scenarios, report each hand-written kernel's "
             "library builds in this process (one each) and its "
             "launches",
    )
    return p.parse_args(argv)


def main() -> None:
    asyncio.run(run(parse_args()))


if __name__ == "__main__":
    main()
