"""Inter-node key placement: replicated consistent hash + region picker.

The cluster-level analog of the mesh shard axis: every peer owns the keys
whose hash lands in its arc of the ring, giving single-writer atomicity by
placement (reference replicated_hash.go:29-119, architecture.md:13-17).
512 virtual replicas per peer smooth the key distribution; replica points are
derived from the md5 hex digest of the peer's gRPC address so the ring is
stable across restarts and insertion orders.

Placement is wire-identical to the reference ring (same vnode derivation and
fnv1/fnv1a key hash), so a mixed reference/tpu cluster routes every key to
the same owner — required for interop and for draining state correctly
during a migration.

The RegionPicker layers one ring per datacenter on top (reference
region_picker.go:23-111): GLOBAL/MULTI_REGION traffic resolves the owner in
every region, local traffic only in ours.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Callable, Dict, Generic, List, Optional, TypeVar

import xxhash

from gubernator_tpu_torch.core.hashing import fnv1_64, fnv1a_64

DEFAULT_REPLICAS = 512


def xx_64(data: bytes) -> int:
    return xxhash.xxh64_intdigest(data)


# Selectable via config `local_picker_hash` / GUBER_PEER_PICKER_HASH
# (reference config.go:403-425).  "xx" is OUR default: FNV's final byte
# barely avalanches, so realistic key sets differing only in a trailing
# id ("account:1", "account:2", ...) hash into a narrow band and can all
# land in one vnode arc — measured 64 consecutive keys all routing to one
# of two peers.  The reference defaults to fnv1 and shares the weakness
# (replicated_hash.go:33); keep fnv1/fnv1a ONLY for placement interop in
# mixed reference/tpu clusters.
HASH_FUNCTIONS: Dict[str, Callable[[bytes], int]] = {
    "xx": xx_64,
    "fnv1": fnv1_64,
    "fnv1a": fnv1a_64,
}

P = TypeVar("P")  # peer handle type — PeerClient in the daemon, anything in tests


class PoolEmptyError(RuntimeError):
    def __init__(self) -> None:
        super().__init__("unable to pick a peer; pool is empty")


class ReplicatedConsistentHash(Generic[P]):
    """Sorted-ring consistent hash with virtual replicas.

    Peers are keyed by their gRPC address (the `key_of` extractor).  Lookup
    is one hash + one binary search — O(log(peers * replicas)).
    """

    def __init__(
        self,
        hash_fn: Optional[Callable[[bytes], int]] = None,
        replicas: int = DEFAULT_REPLICAS,
        key_of: Callable[[P], str] = lambda p: p.info().grpc_address,
    ) -> None:
        self.hash_fn = hash_fn or xx_64
        self.replicas = replicas
        self.key_of = key_of
        self._peers: Dict[str, P] = {}
        self._ring_hashes: List[int] = []
        self._ring_peers: List[P] = []
        self._ring_cache = None

    def new(self) -> "ReplicatedConsistentHash[P]":
        """Fresh empty picker with the same parameters (PeerPicker.New)."""
        return ReplicatedConsistentHash(
            self.hash_fn, self.replicas, self.key_of
        )

    def peers(self) -> List[P]:
        return list(self._peers.values())

    def size(self) -> int:
        return len(self._peers)

    def get_by_address(self, grpc_address: str) -> Optional[P]:
        return self._peers.get(grpc_address)

    def add(self, peer: P) -> None:
        addr = self.key_of(peer)
        self._peers[addr] = peer
        # Vnode points: fnv1(str(i) + md5hex(addr)) — matches the reference
        # derivation (replicated_hash.go:81-90) for placement interop.
        digest = hashlib.md5(addr.encode()).hexdigest()
        points = [
            (self.hash_fn((str(i) + digest).encode()), peer)
            for i in range(self.replicas)
        ]
        merged = sorted(
            list(zip(self._ring_hashes, self._ring_peers)) + points,
            key=lambda t: t[0],
        )
        self._ring_hashes = [h for h, _ in merged]
        self._ring_peers = [p for _, p in merged]
        self._ring_cache = None

    def ring_arrays(self):
        """(ring_hashes uint64[N], ring_peer_idx int32[N], peers list) for
        vectorized owner lookup — one np.searchsorted replaces per-key
        bisects on the compiled routing lane.  Cached until the next add().
        Only meaningful when hash_fn hashes the same bytes the caller
        hashed (the fast router checks hash_fn is xx_64, which equals the
        device fingerprint XXH64 of the hash-key string)."""
        import numpy as np

        if self._ring_cache is None:
            peers = list(self._peers.values())
            index = {id(p): i for i, p in enumerate(peers)}
            self._ring_cache = (
                np.array(self._ring_hashes, dtype=np.uint64),
                np.array(
                    [index[id(p)] for p in self._ring_peers],
                    dtype=np.int32,
                ),
                peers,
            )
        return self._ring_cache

    def get(self, key: str) -> P:
        """Owning peer for `key`: first ring point at/after hash(key),
        wrapping to the start (replicated_hash.go:104-118)."""
        if not self._peers:
            raise PoolEmptyError()
        h = self.hash_fn(key.encode())
        idx = bisect.bisect_left(self._ring_hashes, h)
        if idx == len(self._ring_hashes):
            idx = 0
        return self._ring_peers[idx]

    def get_n(self, key: str, n: int) -> List[P]:
        """The key's owner plus the next distinct peers walking the
        ring clockwise, at most `n` total — the next-N-arcs widened
        owner-set for hot-key mirroring (docs/hotkeys.md).  Every peer
        computes the identical list from the shared ring, so mirror
        membership needs no coordination.  `out[0]` is always `get(key)`;
        a pool smaller than `n` returns every peer, owner first."""
        if not self._peers:
            raise PoolEmptyError()
        return self.get_n_hashed(self.hash_fn(key.encode()), n)

    def get_n_hashed(self, h: int, n: int) -> List[P]:
        """`get_n` from a precomputed ring hash — the fast lane's form
        (an xx ring's hash IS the parser's XXH64 key fingerprint)."""
        if not self._peers:
            raise PoolEmptyError()
        idx = bisect.bisect_left(self._ring_hashes, h)
        total = len(self._ring_hashes)
        out: List[P] = []
        seen = set()
        for k in range(total):
            p = self._ring_peers[(idx + k) % total]
            addr = self.key_of(p)
            if addr in seen:
                continue
            seen.add(addr)
            out.append(p)
            if len(out) >= n or len(out) == len(self._peers):
                break
        return out


class RegionPicker(Generic[P]):
    """One consistent-hash ring per datacenter (region_picker.go:23-111).

    `get_clients(key)` returns the key's owner in EVERY region — the fan-out
    set for MULTI_REGION hit forwarding; `pickers()` exposes the per-region
    rings for health checks.
    """

    def __init__(
        self, template: Optional[ReplicatedConsistentHash[P]] = None
    ) -> None:
        self._template = template or ReplicatedConsistentHash()
        self._regions: Dict[str, ReplicatedConsistentHash[P]] = {}

    def new(self) -> "RegionPicker[P]":
        return RegionPicker(self._template.new())

    def pickers(self) -> Dict[str, ReplicatedConsistentHash[P]]:
        return dict(self._regions)

    def peers(self) -> List[P]:
        out: List[P] = []
        for picker in self._regions.values():
            out.extend(picker.peers())
        return out

    def add(self, peer: P, data_center: str = "") -> None:
        picker = self._regions.get(data_center)
        if picker is None:
            picker = self._template.new()
            self._regions[data_center] = picker
        picker.add(peer)

    def get_clients(self, key: str) -> List[P]:
        return [p.get(key) for p in self._regions.values() if p.size()]

    def get_by_address(self, grpc_address: str) -> Optional[P]:
        for picker in self._regions.values():
            p = picker.get_by_address(grpc_address)
            if p is not None:
                return p
        return None
