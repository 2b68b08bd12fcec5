"""Kubernetes peer discovery (reference kubernetes.go:36-249).

Watches Endpoints (or ready Pods) matching a label selector and maps the
addresses to PeerInfo, marking ourselves by pod IP.  The kubernetes python
client is not baked into this image, so the pool is import-gated: it raises
a clear error at construction when the client is missing, and the watch
logic activates when one is available.
"""
from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from gubernator_tpu_torch.core.types import PeerInfo
from gubernator_tpu_torch.discovery.base import Pool, UpdateFunc

log = logging.getLogger("gubernator_tpu_torch.discovery.k8s")


class K8sPool(Pool):
    def __init__(
        self,
        on_update: UpdateFunc,
        namespace: str = "default",
        selector: str = "",
        pod_ip: str = "",
        pod_port: int = 81,
        mechanism: str = "endpoints",  # endpoints | pods (WatchMechanism)
        poll_interval_s: float = 5.0,
        http_port: int = 80,
    ) -> None:
        try:
            import kubernetes  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "K8sPool requires the 'kubernetes' python client, which is "
                "not available in this environment; use DnsPool against a "
                "headless Service, or GossipPool"
            ) from e
        self.on_update = on_update
        self.namespace = namespace
        self.selector = selector
        self.pod_ip = pod_ip
        self.pod_port = pod_port
        self.http_port = http_port
        self.mechanism = mechanism
        self.poll_interval_s = poll_interval_s
        self._task: Optional[asyncio.Task] = None
        self._v1 = None

    async def start(self) -> None:
        # Load config + build the API client ONCE (the reference wires the
        # informer once, kubernetes.go:36-110), not per poll.
        import kubernetes

        loop = asyncio.get_running_loop()

        def build():
            kubernetes.config.load_incluster_config()
            return kubernetes.client.CoreV1Api()

        self._v1 = await loop.run_in_executor(None, build)
        await self._poll_once()
        self._task = asyncio.ensure_future(self._run())

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.poll_interval_s)
            await self._poll_once()

    async def _poll_once(self) -> None:
        loop = asyncio.get_running_loop()
        peers = await loop.run_in_executor(None, self._list_peers)
        if peers is not None:
            self.on_update(peers)

    def _list_peers(self) -> Optional[List[PeerInfo]]:
        """List endpoint addresses -> PeerInfo (kubernetes.go:190-244)."""
        v1 = self._v1
        peers: List[PeerInfo] = []
        try:
            if self.mechanism == "pods":
                pods = v1.list_namespaced_pod(
                    self.namespace, label_selector=self.selector
                )
                ips = [
                    p.status.pod_ip
                    for p in pods.items
                    if p.status and p.status.pod_ip and _pod_ready(p)
                ]
            else:
                eps = v1.list_namespaced_endpoints(
                    self.namespace, label_selector=self.selector
                )
                ips = [
                    a.ip
                    for ep in eps.items
                    for ss in (ep.subsets or [])
                    for a in (ss.addresses or [])
                ]
        except Exception as e:  # noqa: BLE001
            log.warning("k8s list failed: %s", e)
            return None
        for ip in sorted(set(ips)):
            peers.append(
                PeerInfo(
                    grpc_address=f"{ip}:{self.pod_port}",
                    http_address=f"{ip}:{self.http_port}",
                    is_owner=(ip == self.pod_ip),
                )
            )
        return peers


def _pod_ready(pod) -> bool:
    for c in (pod.status.conditions or []):
        if c.type == "Ready":
            return c.status == "True"
    return False
