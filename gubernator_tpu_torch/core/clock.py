"""Injectable, freezable clock.

The reference routes all algorithm time through holster's clock so tests can
freeze and advance it deterministically (functional_test.go:160, 215;
MillisecondNow lrucache.go:106-108).  On TPU there is no wall clock on device,
so `now` is always a host-computed batch input — which makes this seam even
more central: every device step takes `millisecond_now()` as an argument.
"""
from __future__ import annotations

import threading
import time
from datetime import datetime, timezone
from typing import Optional


class Clock:
    """Monotonic-ish wall clock that can be frozen and manually advanced."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._frozen_ns: Optional[int] = None

    def now_ns(self) -> int:
        with self._lock:
            if self._frozen_ns is not None:
                return self._frozen_ns
        return time.time_ns()

    def now(self) -> datetime:
        return datetime.fromtimestamp(self.now_ns() / 1e9, tz=timezone.utc)

    def millisecond_now(self) -> int:
        """Unix epoch milliseconds — the timestamp unit of the whole protocol
        (reference MillisecondNow, lrucache.go:106-108)."""
        return self.now_ns() // 1_000_000

    def freeze(self, at_ns: Optional[int] = None) -> None:
        with self._lock:
            self._frozen_ns = time.time_ns() if at_ns is None else at_ns

    def advance(self, ms: int) -> None:
        with self._lock:
            if self._frozen_ns is None:
                raise RuntimeError("clock is not frozen")
            self._frozen_ns += ms * 1_000_000

    def unfreeze(self) -> None:
        with self._lock:
            self._frozen_ns = None

    @property
    def frozen(self) -> bool:
        with self._lock:
            return self._frozen_ns is not None


# Module-level default clock, mirroring holster's global clock.
_default = Clock()


def default_clock() -> Clock:
    return _default


def now() -> datetime:
    return _default.now()


def millisecond_now() -> int:
    return _default.millisecond_now()


def freeze(at_ns: Optional[int] = None) -> None:
    _default.freeze(at_ns)


def advance(ms: int) -> None:
    _default.advance(ms)


def unfreeze() -> None:
    _default.unfreeze()


class frozen_time:
    """Context manager for tests::

        with frozen_time() as clk:
            ...
            clk.advance(1000)
    """

    def __init__(self, at_ns: Optional[int] = None) -> None:
        self._at_ns = at_ns

    def __enter__(self) -> Clock:
        _default.freeze(self._at_ns)
        return _default

    def __exit__(self, *exc) -> None:
        _default.unfreeze()
