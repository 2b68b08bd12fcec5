"""Load generator CLI (reference cmd/gubernator-cli/main.go:52-224).

Generates N random rate limits and replays them endlessly against a daemon
with a concurrency fan-out, optional client-side rate limiting and batch
size, reporting throughput and over-limit counts.
"""
from __future__ import annotations

import argparse
import asyncio
import random
import time

from gubernator_tpu_torch.client import AsyncV1Client, random_string
from gubernator_tpu_torch.core.types import Algorithm, RateLimitReq


def make_rate_limits(n: int) -> list:
    """2000 random limits by default (main.go:117-129)."""
    out = []
    for _ in range(n):
        out.append(
            RateLimitReq(
                name=random_string("ID-", 6),
                unique_key=random_string("", 10),
                hits=1,
                limit=random.randint(1, 100),
                duration=random.randint(1, 60) * 1000,
                algorithm=random.choice(list(Algorithm)),
            )
        )
    return out


async def run(args) -> None:
    limits = make_rate_limits(args.limits)
    client = AsyncV1Client(args.address)
    stats = {"checks": 0, "over": 0, "errors": 0}
    t0 = time.monotonic()

    async def worker() -> None:
        while time.monotonic() - t0 < args.seconds:
            batch = random.sample(limits, min(args.checks, len(limits)))
            try:
                resps = await client.get_rate_limits(batch, timeout=5.0)
            except Exception:  # noqa: BLE001
                stats["errors"] += len(batch)
                continue
            stats["checks"] += len(resps)
            stats["over"] += sum(1 for r in resps if int(r.status) == 1)
            if args.rate > 0:
                await asyncio.sleep(len(batch) / args.rate)

    await asyncio.gather(*(worker() for _ in range(args.concurrency)))
    dt = time.monotonic() - t0
    print(
        f"checks={stats['checks']} over_limit={stats['over']} "
        f"errors={stats['errors']} elapsed={dt:.1f}s "
        f"rate={stats['checks'] / dt:,.0f}/s"
    )
    await client.close()


def main() -> None:
    p = argparse.ArgumentParser(description="gubernator load generator (torch port)")
    p.add_argument("--address", default="localhost:1051")
    p.add_argument("--limits", type=int, default=2000,
                   help="distinct random rate limits")
    p.add_argument("--checks", type=int, default=10,
                   help="checks per request batch")
    p.add_argument("--concurrency", type=int, default=32)
    p.add_argument("--rate", type=float, default=0,
                   help="client-side checks/sec cap per worker (0=off)")
    p.add_argument("--seconds", type=float, default=10.0)
    asyncio.run(run(p.parse_args()))


if __name__ == "__main__":
    main()
