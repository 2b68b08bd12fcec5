"""Local dev cluster CLI (reference cmd/gubernator-cluster/main.go:29-56).

Spawns a 6-node in-process cluster of the port's daemons on fixed
localhost ports for client development, and serves until interrupted:

    python -m gubernator_tpu_torch.cli.cluster [--nodes N]

The daemons run on the CUDA card unless GUBER_TPU_PLATFORM=cpu asks for the
CPU.
"""
from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal

from gubernator_tpu_torch.core.config import (
    DaemonConfig,
    DeviceConfig,
    fast_test_behaviors,
)
from gubernator_tpu_torch.core.types import PeerInfo
from gubernator_tpu_torch.daemon import Daemon

BASE_GRPC = 9990
BASE_HTTP = 9980


async def run(n: int) -> None:
    daemons = []
    for i in range(n):
        conf = DaemonConfig(
            grpc_listen_address=f"127.0.0.1:{BASE_GRPC + i}",
            http_listen_address=f"127.0.0.1:{BASE_HTTP + i}",
            behaviors=fast_test_behaviors(),
            device=DeviceConfig(
                num_slots=65_536, batch_size=1024,
                platform=os.environ.get("GUBER_TPU_PLATFORM") or None,
            ),
        )
        d = Daemon(conf)
        await d.start()
        d.conf.advertise_address = d.grpc_address
        daemons.append(d)
    peers = [
        PeerInfo(grpc_address=d.grpc_address, http_address=d.http_address)
        for d in daemons
    ]
    for d in daemons:
        await d.set_peers(peers)
    print("cluster ready:")
    for d in daemons:
        print(f"  grpc={d.grpc_address}  http={d.http_address}")

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    for d in daemons:
        await d.close()


def main() -> None:
    p = argparse.ArgumentParser(
        description="local gubernator cluster (torch port)")
    p.add_argument("--nodes", type=int, default=6)
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    asyncio.run(run(args.nodes))


if __name__ == "__main__":
    main()
