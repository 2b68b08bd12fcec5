"""Persistence SPI: Store (write-through) and Loader (bulk load/save).

Mirrors the reference contracts (store.go:49-78): a `Store` sees every state
change and cache miss synchronously with request processing; a `Loader` bulk
restores the cache before serving and bulk saves it at shutdown.

The device re-expression works at BATCH granularity instead of per item
(there is no per-item hook point inside a device kernel):

- miss seeding: before a device step, one `probe_batch` gather finds the
  batch's missing keys; `Store.get` is consulted for those and hits are bulk
  upserted via `load_rows` (replacing the in-algorithm s.Get calls,
  algorithms.go:45-51);
- write-through: after the step, written rows are read back with one more
  `probe_batch` + row DMA and handed to `Store.on_change` (replacing the
  in-algorithm s.OnChange calls, algorithms.go:154-158);
- bulk load/save: `Loader.load()` yields CacheItems streamed to device in
  batch-size chunks; `save()` receives the live rows of the final table
  (workers.go:340-426, 467-530).

The backend keeps a fingerprint->key-string map only while a Store/Loader is
attached, so key strings can be reconstructed on save (device rows hold only
64-bit fingerprints).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Iterator, List, Optional

from gubernator_tpu_torch.core.types import Algorithm, CacheItem, RateLimitReq


class Store:
    """Write-through persistence hooks (reference store.go:49-65).

    Implementations must tolerate batch-granular calls: `on_change` receives
    the post-step state of every persisted request in the batch.
    """

    def get(self, req: RateLimitReq) -> Optional[CacheItem]:
        """Called on cache miss; return the persisted item or None."""
        raise NotImplementedError

    def on_change(self, req: RateLimitReq, item: CacheItem) -> None:
        """Called after the request's state changed on device."""
        raise NotImplementedError

    def remove(self, key: str) -> None:
        """Called when an item is explicitly invalidated."""
        raise NotImplementedError


class Loader:
    """Bulk persistence (reference store.go:69-78)."""

    def load(self) -> Iterable[CacheItem]:
        """Yield items to preload before serving."""
        raise NotImplementedError

    def save(self, items: Iterator[CacheItem]) -> None:
        """Consume the live items at shutdown."""
        raise NotImplementedError


class MockStore(Store):
    """Dict-backed Store, mirroring the in-library mock (store.go:80-106)."""

    def __init__(self) -> None:
        self.called: Dict[str, int] = {"get": 0, "on_change": 0, "remove": 0}
        self.data: Dict[str, CacheItem] = {}
        self._lock = threading.Lock()

    def get(self, req: RateLimitReq) -> Optional[CacheItem]:
        with self._lock:
            self.called["get"] += 1
            return self.data.get(req.hash_key())

    def on_change(self, req: RateLimitReq, item: CacheItem) -> None:
        with self._lock:
            self.called["on_change"] += 1
            self.data[item.key] = item

    def remove(self, key: str) -> None:
        with self._lock:
            self.called["remove"] += 1
            self.data.pop(key, None)


class MockLoader(Loader):
    """List-backed Loader, mirroring store.go:108-150."""

    def __init__(self, items: Optional[List[CacheItem]] = None) -> None:
        self.called: Dict[str, int] = {"load": 0, "save": 0}
        self.contents: List[CacheItem] = list(items or [])

    def load(self) -> Iterable[CacheItem]:
        self.called["load"] += 1
        return list(self.contents)

    def save(self, items: Iterator[CacheItem]) -> None:
        self.called["save"] += 1
        self.contents = list(items)


def item_to_row_fields(item: CacheItem) -> dict:
    """CacheItem -> BucketRows field dict (minus key_hash)."""
    leaky = item.algorithm == Algorithm.LEAKY_BUCKET
    return dict(
        algo=int(item.algorithm),
        limit=int(item.limit),
        duration=int(item.duration),
        remaining=0 if leaky else int(item.remaining),
        remaining_f=float(item.remaining) if leaky else 0.0,
        t0=int(item.created_at),
        status=int(item.status),
        burst=int(item.burst) if item.burst else int(item.limit),
        expire_at=int(item.expire_at),
    )
