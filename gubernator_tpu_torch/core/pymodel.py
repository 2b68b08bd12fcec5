"""Exact sequential rate-limit model (host fallback + differential oracle).

This is a faithful re-derivation of the reference algorithm semantics
(algorithms.go:31-492) over a plain dict cache.  It exists for three reasons:

1. Differential testing: the vectorized decision step
   (gubernator_tpu_torch.ops.step) and its kernel must produce
   byte-identical decisions; tests drive random op streams through both
   and compare.
2. Host fallback backend when no accelerator is configured.
3. The Loader/Store persistence SPI operates on these CacheItem records.

A copy of the JAX package's oracle (gubernator_tpu/core/pymodel.py) over
this package's own core modules.

Every special case is labeled with its reference file:line.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from gubernator_tpu_torch.core import clock as clock_mod
from gubernator_tpu_torch.core.interval import (
    gregorian_duration,
    gregorian_expiration,
)
from gubernator_tpu_torch.core.types import (
    Algorithm,
    Behavior,
    CacheItem,
    RateLimitReq,
    RateLimitResp,
    Status,
    has_behavior,
)


_I64_MAX = 2**63 - 1
_I64_MIN = -(2**63)


def _trunc(x: float) -> int:
    """Go's int64(float64) — truncation toward zero — pinned to the
    device kernel's exact edge semantics (ops/step.py _trunc_i64):
    out-of-range values SATURATE at the int64 bounds and NaN maps to 0
    (XLA convert behavior; Go itself is implementation-dependent here —
    amd64 collapses all three cases to INT64_MIN).  A bare
    int(math.trunc(x)) would diverge beyond ±2^63 (python ints are
    unbounded) and raise on NaN/inf; the differential suite
    (tests/test_differential.py::test_go_trunc_differential) holds the
    two implementations bit-identical across the full edge matrix."""
    if math.isnan(x):
        return 0
    if x >= _I64_MAX:
        return _I64_MAX
    if x <= _I64_MIN:
        return _I64_MIN
    return int(math.trunc(x))


def _clamp_i64(x: int) -> int:
    if x > _I64_MAX:
        return _I64_MAX
    if x < _I64_MIN:
        return _I64_MIN
    return x


def _sat_add(a: int, b: int) -> int:
    """Saturating int64 add — the oracle half of the device's
    _sat_add_i64 (ops/step.py).  The device clamps the addend into the
    room the augend leaves, which equals clamping the exact
    unbounded-int sum; composed saturating ops must still clamp STEP BY
    STEP in the same order as the device, not clamp one exact total."""
    return _clamp_i64(a + b)


def _sat_sub(a: int, b: int) -> int:
    """Saturating int64 subtract (see _sat_add)."""
    return _clamp_i64(a - b)


class PyRateLimiter:
    """Sequential, exact rate limiter over a dict cache."""

    def __init__(self, clock: Optional[clock_mod.Clock] = None) -> None:
        self.cache: Dict[str, CacheItem] = {}
        self.clock = clock or clock_mod.default_clock()

    # -- public ----------------------------------------------------------
    def get_rate_limit(self, r: RateLimitReq) -> RateLimitResp:
        if r.algorithm == Algorithm.TOKEN_BUCKET:
            return self._token_bucket(r)
        return self._leaky_bucket(r)

    # -- token bucket (algorithms.go:31-258) -----------------------------
    def _token_bucket(self, r: RateLimitReq) -> RateLimitResp:
        now = self.clock.millisecond_now()
        key = r.hash_key()
        item = self.cache.get(key)
        # Expiry is handled by the cache in the reference (lrucache.go:115-127
        # returns miss for expired items); emulate here.
        if item is not None and item.is_expired(now):
            del self.cache[key]
            item = None

        if item is not None:
            if has_behavior(r.behavior, Behavior.RESET_REMAINING):
                # algorithms.go:78-90: remove and answer fresh.
                del self.cache[key]
                return RateLimitResp(
                    status=Status.UNDER_LIMIT,
                    limit=r.limit,
                    remaining=r.limit,
                    reset_time=0,
                )
            if item.algorithm != Algorithm.TOKEN_BUCKET or item.cached_resp is not None:
                # Algorithm switch (algorithms.go:97-109): drop + recreate.
                del self.cache[key]
                return self._token_bucket_new(r, now)

            # Limit change (algorithms.go:112-119).  Saturating like the
            # device (step-by-step: add, then sub).
            if item.limit != r.limit:
                item.remaining = max(
                    _sat_sub(
                        _sat_add(int(item.remaining), r.limit), item.limit
                    ),
                    0,
                )
                item.limit = r.limit

            rl = RateLimitResp(
                status=item.status,
                limit=r.limit,
                remaining=int(item.remaining),
                reset_time=item.expire_at,
            )

            # Duration change (algorithms.go:129-152).
            if item.duration != r.duration:
                if has_behavior(r.behavior, Behavior.DURATION_IS_GREGORIAN):
                    expire = gregorian_expiration(self.clock.now(), r.duration)
                else:
                    expire = _sat_add(item.created_at, r.duration)
                if expire <= now:
                    # Renew (algorithms.go:141-147).
                    expire = _sat_add(now, r.duration)
                    item.created_at = now
                    item.remaining = item.limit
                item.expire_at = expire
                item.duration = r.duration
                rl.reset_time = expire

            # Hits==0 status read (algorithms.go:162-164).
            if r.hits == 0:
                return rl

            # Already at the limit (algorithms.go:167-173) — tests the
            # RESPONSE remaining (pre-duration-renew), not item.remaining.
            if rl.remaining == 0 and r.hits > 0:
                rl.status = Status.OVER_LIMIT
                item.status = Status.OVER_LIMIT
                return rl

            # Exact take (algorithms.go:176-181) — tests ITEM remaining.
            if int(item.remaining) == r.hits:
                item.remaining = 0
                rl.remaining = 0
                return rl

            # Over without mutation (algorithms.go:185-190).
            if r.hits > int(item.remaining):
                rl.status = Status.OVER_LIMIT
                return rl

            # Under (algorithms.go:192-195).
            item.remaining = int(item.remaining) - r.hits
            rl.remaining = int(item.remaining)
            return rl

        return self._token_bucket_new(r, now)

    def _token_bucket_new(self, r: RateLimitReq, now: int) -> RateLimitResp:
        """algorithms.go:203-258."""
        if has_behavior(r.behavior, Behavior.DURATION_IS_GREGORIAN):
            expire = gregorian_expiration(self.clock.now(), r.duration)
        else:
            expire = _sat_add(now, r.duration)
        remaining = r.limit - r.hits
        rl = RateLimitResp(
            status=Status.UNDER_LIMIT,
            limit=r.limit,
            remaining=remaining,
            reset_time=expire,
        )
        if r.hits > r.limit:
            # algorithms.go:243-249: over on first hit; stored status stays
            # UNDER (only rl.Status flips).
            rl.status = Status.OVER_LIMIT
            rl.remaining = r.limit
            remaining = r.limit
        self.cache[r.hash_key()] = CacheItem(
            key=r.hash_key(),
            algorithm=Algorithm.TOKEN_BUCKET,
            expire_at=expire,
            limit=r.limit,
            duration=r.duration,
            remaining=remaining,
            created_at=now,
            status=Status.UNDER_LIMIT,
        )
        return rl

    # -- leaky bucket (algorithms.go:261-492) ----------------------------
    def _leaky_bucket(self, r: RateLimitReq) -> RateLimitResp:
        burst = r.burst if r.burst != 0 else r.limit  # algorithms.go:271-272
        now = self.clock.millisecond_now()
        key = r.hash_key()
        item = self.cache.get(key)
        if item is not None and item.is_expired(now):
            del self.cache[key]
            item = None

        if item is None:
            return self._leaky_bucket_new(r, burst, now)

        if item.algorithm != Algorithm.LEAKY_BUCKET or item.cached_resp is not None:
            # Algorithm switch (algorithms.go:315-325).
            del self.cache[key]
            return self._leaky_bucket_new(r, burst, now)

        rem = float(item.remaining)

        # RESET_REMAINING (algorithms.go:327-329): remaining := burst.
        if has_behavior(r.behavior, Behavior.RESET_REMAINING):
            rem = float(burst)

        # Burst change (algorithms.go:332-337).
        if item.burst != burst:
            if burst > _trunc(rem):
                rem = float(burst)
            item.burst = burst

        item.limit = r.limit
        item.duration = r.duration  # stored as the RAW duration here
        duration = r.duration
        rate = duration / r.limit if r.limit != 0 else 0.0

        if has_behavior(r.behavior, Behavior.DURATION_IS_GREGORIAN):
            # algorithms.go:345-361: rate from the FULL interval duration;
            # duration = remaining time until interval end.
            d = gregorian_duration(self.clock.now(), r.duration)
            rate = d / r.limit if r.limit != 0 else 0.0
            duration = gregorian_expiration(self.clock.now(), r.duration) - now

        if r.hits != 0:
            item.expire_at = _sat_add(now, duration)  # algorithms.go:363-365

        # Leak (algorithms.go:367-378).
        elapsed = now - item.created_at
        leak = elapsed / rate if rate != 0 else 0.0
        if _trunc(leak) > 0:
            rem += leak
            item.created_at = now
        if _trunc(rem) > burst:
            rem = float(burst)

        rem_i = _trunc(rem)
        rate_i = _trunc(rate)
        # ResetTime in float64 + saturating truncation, mirroring the
        # device's evaluation order exactly (ops/step.py le_resp_reset):
        # exact below 2^53, saturates instead of wrapping beyond int64.
        rl = RateLimitResp(
            status=Status.UNDER_LIMIT,
            limit=item.limit,
            remaining=rem_i,
            reset_time=_trunc(
                float(now) + (float(item.limit) - float(rem_i))
                * float(rate_i)
            ),
        )

        if rem_i == 0 and r.hits > 0:
            # algorithms.go:396-400.
            rl.status = Status.OVER_LIMIT
            item.remaining = rem
            return rl

        if rem_i == r.hits:
            # algorithms.go:403-408: exact take.
            rem -= float(r.hits)
            item.remaining = rem
            rl.remaining = 0
            rl.reset_time = _trunc(
                float(now) + (float(rl.limit) - 0.0) * float(rate_i)
            )
            return rl

        if r.hits > rem_i:
            # algorithms.go:412-416.
            rl.status = Status.OVER_LIMIT
            item.remaining = rem
            return rl

        if r.hits == 0:
            # algorithms.go:419-421.
            item.remaining = rem
            return rl

        # Under (algorithms.go:423-426).
        rem -= float(r.hits)
        item.remaining = rem
        rl.remaining = _trunc(rem)
        rl.reset_time = _trunc(
            float(now) + (float(rl.limit) - float(rl.remaining))
            * float(rate_i)
        )
        return rl

    def _leaky_bucket_new(
        self, r: RateLimitReq, burst: int, now: int
    ) -> RateLimitResp:
        """algorithms.go:433-492."""
        duration = r.duration
        # Quirk preserved: rate uses the RAW r.duration even under
        # DURATION_IS_GREGORIAN (algorithms.go:440-451 computes rate before
        # the gregorian adjustment and never recomputes it).
        rate = duration / r.limit if r.limit != 0 else 0.0
        if has_behavior(r.behavior, Behavior.DURATION_IS_GREGORIAN):
            duration = gregorian_expiration(self.clock.now(), r.duration) - now

        rem = float(burst - r.hits)
        rate_i = _trunc(rate)
        rl = RateLimitResp(
            status=Status.UNDER_LIMIT,
            limit=r.limit,
            remaining=burst - r.hits,
            reset_time=_trunc(
                float(now) + (float(r.limit) - float(burst - r.hits))
                * float(rate_i)
            ),
        )
        if r.hits > burst:
            # algorithms.go:470-476.
            rl.status = Status.OVER_LIMIT
            rl.remaining = 0
            rl.reset_time = _trunc(
                float(now) + (float(rl.limit) - 0.0) * float(rate_i)
            )
            rem = 0.0
        self.cache[r.hash_key()] = CacheItem(
            key=r.hash_key(),
            algorithm=Algorithm.LEAKY_BUCKET,
            expire_at=_sat_add(now, duration),
            limit=r.limit,
            duration=duration,  # stored as the COMPUTED duration here
            remaining=rem,
            created_at=now,
            burst=burst,
        )
        return rl
