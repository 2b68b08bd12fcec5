"""DNS-based peer discovery (reference dns.go:114-218).

Polls the A/AAAA records of an FQDN on an interval; every resolved IP
becomes a peer at the configured gRPC/HTTP ports (the reference fixes
ports :81/:80, dns.go:155-168 — here they are configurable).  Uses the
stdlib resolver (getaddrinfo); the reference's miekg/dns TTL-driven
re-poll becomes a fixed poll interval.
"""
from __future__ import annotations

import asyncio
import logging
import socket
from typing import List, Optional, Set

from gubernator_tpu_torch.core.types import PeerInfo
from gubernator_tpu_torch.discovery.base import Pool, UpdateFunc

log = logging.getLogger("gubernator_tpu_torch.discovery.dns")


class DnsPool(Pool):
    def __init__(
        self,
        fqdn: str,
        on_update: UpdateFunc,
        grpc_port: int = 81,
        http_port: int = 80,
        poll_interval_s: float = 10.0,
        data_center: str = "",
        own_address: str = "",
    ) -> None:
        self.fqdn = fqdn
        self.on_update = on_update
        self.grpc_port = grpc_port
        self.http_port = http_port
        self.poll_interval_s = poll_interval_s
        self.data_center = data_center
        self.own_address = own_address
        self._task: Optional[asyncio.Task] = None
        self._last: Set[str] = set()

    async def start(self) -> None:
        await self._poll_once()
        self._task = asyncio.ensure_future(self._run())

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.poll_interval_s)
            await self._poll_once()

    async def _poll_once(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            infos = await loop.getaddrinfo(
                self.fqdn, None, type=socket.SOCK_STREAM
            )
        except socket.gaierror as e:
            log.warning("resolving %s: %s", self.fqdn, e)
            return
        ips = sorted({i[4][0] for i in infos})
        if set(ips) == self._last:
            return
        self._last = set(ips)
        peers: List[PeerInfo] = []
        for ip in ips:
            host = f"[{ip}]" if ":" in ip else ip
            addr = f"{host}:{self.grpc_port}"
            peers.append(
                PeerInfo(
                    grpc_address=addr,
                    http_address=f"{host}:{self.http_port}",
                    data_center=self.data_center,
                    is_owner=(addr == self.own_address),
                )
            )
        log.info("dns peers updated: %s", [p.grpc_address for p in peers])
        self.on_update(peers)
