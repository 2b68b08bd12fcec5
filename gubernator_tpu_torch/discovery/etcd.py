"""etcd peer discovery (reference etcd.go:43-353).

Registers this node under `<prefix>/<addr>` with a keep-alive lease and
watches the prefix, rebuilding the peer set on changes; the key is deleted
and the lease revoked on close.  The etcd3 python client is not baked into
this image, so the pool is import-gated with a clear error; the
registration/watch logic activates when a client is available.
"""
from __future__ import annotations

import asyncio
import json
import logging
from typing import Dict, Optional

from gubernator_tpu_torch.core.types import PeerInfo
from gubernator_tpu_torch.discovery.base import Pool, UpdateFunc

log = logging.getLogger("gubernator_tpu_torch.discovery.etcd")

LEASE_TTL_S = 30  # etcd.go:30s lease + keepalive


class EtcdPool(Pool):
    def __init__(
        self,
        on_update: UpdateFunc,
        self_info: PeerInfo,
        endpoints: str = "localhost:2379",
        key_prefix: str = "/gubernator/peers/",
    ) -> None:
        try:
            import etcd3  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "EtcdPool requires the 'etcd3' python client, which is not "
                "available in this environment; use DnsPool or GossipPool"
            ) from e
        self.on_update = on_update
        self.self_info = self_info
        self.endpoints = endpoints
        self.key_prefix = key_prefix
        self._client = None
        self._lease = None
        self._watch_id = None
        self._keepalive_task: Optional[asyncio.Task] = None
        self._peers: Dict[str, PeerInfo] = {}

    async def start(self) -> None:
        import etcd3

        host, _, port = self.endpoints.partition(":")
        loop = asyncio.get_running_loop()
        self._client = await loop.run_in_executor(
            None, lambda: etcd3.client(host=host, port=int(port or 2379))
        )
        await self._register()
        await self._scan()
        self._watch_id = self._client.add_watch_prefix_callback(
            self.key_prefix, self._on_event
        )
        self._keepalive_task = asyncio.ensure_future(self._keepalive())

    async def close(self) -> None:
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
            await asyncio.gather(
                self._keepalive_task, return_exceptions=True
            )
        if self._client is not None:
            loop = asyncio.get_running_loop()

            def teardown() -> None:
                # Blocking etcd RPCs — keep them off the event loop.
                if self._watch_id is not None:
                    self._client.cancel_watch(self._watch_id)
                key = self.key_prefix + self.self_info.grpc_address
                self._client.delete(key)
                if self._lease is not None:
                    self._lease.revoke()

            try:
                await asyncio.wait_for(
                    loop.run_in_executor(None, teardown), timeout=10.0
                )
            except (asyncio.TimeoutError, Exception) as e:  # noqa: BLE001
                log.warning("etcd teardown failed: %s", e)

    async def _register(self) -> None:
        """Put our PeerInfo under a leased key (etcd.go:222-260)."""
        loop = asyncio.get_running_loop()

        def put():
            self._lease = self._client.lease(LEASE_TTL_S)
            key = self.key_prefix + self.self_info.grpc_address
            from dataclasses import asdict

            self._client.put(
                key, json.dumps(asdict(self.self_info)), lease=self._lease
            )

        await loop.run_in_executor(None, put)

    async def _keepalive(self) -> None:
        """Refresh the lease; re-register if it was lost
        (etcd.go:262-313)."""
        while True:
            await asyncio.sleep(LEASE_TTL_S / 3)
            loop = asyncio.get_running_loop()
            try:
                ok = await loop.run_in_executor(
                    None, lambda: list(self._lease.refresh())
                )
                if not ok or ok[0].TTL == 0:
                    await self._register()
            except Exception as e:  # noqa: BLE001
                log.warning("etcd keepalive failed, re-registering: %s", e)
                try:
                    await self._register()
                except Exception:  # noqa: BLE001
                    pass

    async def _scan(self) -> None:
        loop = asyncio.get_running_loop()
        kvs = await loop.run_in_executor(
            None, lambda: list(self._client.get_prefix(self.key_prefix))
        )
        self._peers = {}
        for value, meta in kvs:
            self._add_kv(meta.key.decode(), value)
        self._publish()

    def _on_event(self, response) -> None:
        for ev in response.events:
            key = ev.key.decode()
            if ev.__class__.__name__.startswith("Delete"):
                self._peers.pop(key, None)
            else:
                self._add_kv(key, ev.value)
        self._publish()

    def _add_kv(self, key: str, value: bytes) -> None:
        try:
            self._peers[key] = PeerInfo(**json.loads(value.decode()))
        except (ValueError, TypeError):
            log.warning("bad peer record at %s", key)

    def _publish(self) -> None:
        peers = []
        for p in self._peers.values():
            peers.append(
                PeerInfo(
                    grpc_address=p.grpc_address,
                    http_address=p.http_address,
                    data_center=p.data_center,
                    is_owner=(
                        p.grpc_address == self.self_info.grpc_address
                    ),
                )
            )
        self.on_update(sorted(peers, key=lambda p: p.grpc_address))
