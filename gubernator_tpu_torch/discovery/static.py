"""Static peer list — the no-discovery baseline.

The reference reaches this via GUBER_PEERS-style manual SetPeers wiring in
tests (cluster/cluster.go:111-146); here it is a first-class pool.
"""
from __future__ import annotations

from typing import List, Sequence

from gubernator_tpu_torch.core.types import PeerInfo
from gubernator_tpu_torch.discovery.base import Pool, UpdateFunc


class StaticPool(Pool):
    def __init__(
        self, peers: Sequence[PeerInfo], on_update: UpdateFunc
    ) -> None:
        self.peers: List[PeerInfo] = list(peers)
        self.on_update = on_update

    async def start(self) -> None:
        self.on_update(self.peers)

    async def close(self) -> None:
        pass
