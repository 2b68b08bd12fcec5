"""Core request/response types and enums.

Mirrors the reference wire contract (proto/gubernator.proto:57-182,
proto/peers.proto:36-57) as plain Python dataclasses.  These are the host-side
currency of the framework; the device layer consumes them as packed arrays
(see gubernator_tpu_torch.ops.batch).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class Algorithm(enum.IntEnum):
    """Rate-limit algorithm (gubernator.proto:57-62)."""

    TOKEN_BUCKET = 0
    LEAKY_BUCKET = 1


class Behavior(enum.IntFlag):
    """Behavior flag bits (gubernator.proto:65-131).

    BATCHING is the zero value (default); the rest are single bits that can be
    OR-ed together.
    """

    BATCHING = 0
    NO_BATCHING = 1
    GLOBAL = 2
    DURATION_IS_GREGORIAN = 4
    RESET_REMAINING = 8
    MULTI_REGION = 16


class Status(enum.IntEnum):
    """Rate-limit decision (gubernator.proto:164-167)."""

    UNDER_LIMIT = 0
    OVER_LIMIT = 1


def has_behavior(b: int, flag: Behavior) -> bool:
    """Bit test, reference gubernator.go:782-785."""
    return bool(int(b) & int(flag))


# Duration convenience constants (reference client.go:31-35).
MILLISECOND = 1
SECOND = 1000
MINUTE = 60 * SECOND
HOUR = 60 * MINUTE


@dataclass
class RateLimitReq:
    """One rate-limit check (gubernator.proto:133-162)."""

    name: str = ""
    unique_key: str = ""
    hits: int = 0
    limit: int = 0
    duration: int = 0  # milliseconds (or Gregorian interval id 0-5)
    algorithm: Algorithm = Algorithm.TOKEN_BUCKET
    behavior: Behavior = Behavior.BATCHING
    burst: int = 0

    def hash_key(self) -> str:
        """Canonical cache key: Name + "_" + UniqueKey (client.go:37-39)."""
        return self.name + "_" + self.unique_key


@dataclass
class RateLimitResp:
    """One rate-limit answer (gubernator.proto:169-182)."""

    status: Status = Status.UNDER_LIMIT
    limit: int = 0
    remaining: int = 0
    reset_time: int = 0  # unix ms
    error: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)


@dataclass
class GetRateLimitsReq:
    requests: List[RateLimitReq] = field(default_factory=list)


@dataclass
class GetRateLimitsResp:
    responses: List[RateLimitResp] = field(default_factory=list)


@dataclass
class HealthCheckResp:
    """gubernator.proto:185-192."""

    status: str = "healthy"
    message: str = ""
    peer_count: int = 0


@dataclass
class UpdatePeerGlobal:
    """peers.proto:52-56 — owner-authoritative status pushed to peers."""

    key: str = ""
    status: Optional[RateLimitResp] = None
    algorithm: Algorithm = Algorithm.TOKEN_BUCKET


@dataclass
class LeaseGrant:
    """One granted (or refused) client-side admission lease
    (peers.proto Lease/Reconcile; docs/leases.md).

    `allowance` hits may be burned locally with zero RPCs until
    `expires_at` (unix ms); a non-empty `refusal` means no allowance was
    granted (allowance == 0) and the holder must degrade to per-call
    checks.  `reset_time` is the carve slot's window reset — the
    holder's local remaining/reset view between reconciles."""

    key: str = ""  # hash key (name + "_" + unique_key)
    allowance: int = 0
    expires_at: int = 0  # unix ms
    reset_time: int = 0  # unix ms
    limit: int = 0
    refusal: str = ""  # empty = granted

    @property
    def granted(self) -> bool:
        return self.allowance > 0 and not self.refusal


@dataclass
class ReconcileItem:
    """One holder->owner reconcile entry: `request.hits` carries the
    hits burned locally since the last reconcile (0 = nothing new);
    `release` drops the holder's grant outright; `renew` piggybacks a
    grant refresh on the reconcile RPC (the low-water refresh without a
    second round trip)."""

    request: RateLimitReq = field(default_factory=RateLimitReq)
    release: bool = False
    renew: bool = False


@dataclass(frozen=True)
class PeerInfo:
    """Cluster-membership record (reference config.go peer info struct)."""

    grpc_address: str = ""
    http_address: str = ""
    data_center: str = ""
    is_owner: bool = False  # true only for the local instance


@dataclass
class CacheItem:
    """Host-side representation of one cached entry, used by the Store/Loader
    persistence SPI (reference cache.go:30-42).  On device the same record is
    a row across the SlotTable arrays; this form is the DMA'd host view.
    """

    key: str = ""
    algorithm: Algorithm = Algorithm.TOKEN_BUCKET
    expire_at: int = 0
    invalid_at: int = 0
    # Algorithm payload (TokenBucketItem store.go:37-43 / LeakyBucketItem
    # store.go:29-35), flattened:
    limit: int = 0
    duration: int = 0
    remaining: float = 0.0  # int-valued for token bucket, float for leaky
    created_at: int = 0  # token CreatedAt / leaky UpdatedAt
    status: Status = Status.UNDER_LIMIT
    burst: int = 0
    # When a GLOBAL broadcast response is cached on a non-owner the stored
    # value is a whole RateLimitResp (gubernator.go:464-479):
    cached_resp: Optional[RateLimitResp] = None

    def is_expired(self, now_ms: int) -> bool:
        if self.invalid_at and self.invalid_at <= now_ms:
            return True
        return self.expire_at <= now_ms
