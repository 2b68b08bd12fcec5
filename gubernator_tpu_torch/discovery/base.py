"""Discovery pool interface (reference PoolInterface, etcd.go:39-41)."""
from __future__ import annotations

from typing import Callable, List, Sequence

from gubernator_tpu_torch.core.types import PeerInfo

UpdateFunc = Callable[[Sequence[PeerInfo]], None]


class Pool:
    """A source of cluster membership updates."""

    async def start(self) -> None:
        raise NotImplementedError

    async def close(self) -> None:
        raise NotImplementedError


def dedupe_peers(peers: List[PeerInfo]) -> List[PeerInfo]:
    seen = set()
    out: List[PeerInfo] = []
    for p in peers:
        if p.grpc_address not in seen:
            seen.add(p.grpc_address)
            out.append(p)
    return out
