"""Per-peer circuit breaker: closed -> open -> half-open -> closed.

The reference has no breaker: a dead or flapping owner peer makes every
forwarded check burn the full `batch_timeout_s` budget before failing —
exactly the coordination-failure regime "When Two is Worse Than One"
(arXiv:1909.08969) shows can make a distributed limiter worse than none.
This breaker turns a dead peer into a fast, bounded failure:

  CLOSED     normal service.  `failure_threshold` CONSECUTIVE failures
             (any success resets the count) trip it OPEN.  The failures
             are the same events that feed the 5-minute HealthCheck
             error window (`PeerClient._record_error`), so the breaker
             cannot disagree with the health plane about what an error
             is.
  OPEN       every attempt sheds immediately (`PeerNotReadyError` at
             the enqueue gate, no RPC, no deadline burned) until a
             jittered exponential backoff expires:
             `base_backoff_s * 2^(streak-1)` capped at `max_backoff_s`,
             multiplied by a uniform ±`jitter` factor so a cluster of
             clients doesn't re-probe a recovering peer in lockstep
             (the thundering-herd reconnect the backoff literature
             warns about).
  HALF_OPEN  after the backoff, `half_open_probes` probe RPCs are
             admitted (`allow()` consumes a token; everything else
             still sheds).  One probe success re-closes the breaker and
             resets the backoff streak; one probe failure re-opens it
             with the streak (and therefore the backoff) doubled.  A
             probe whose RPC never reports an outcome — e.g. the gated
             call is torn down by CancelledError before the peer-client
             error path can run — would otherwise wedge the breaker
             half-open forever (tokens spent, nothing to return them);
             `probe_timeout_s` after the last probe was issued with all
             tokens spent and no outcome, the gates treat the probe as
             failed and re-open with the backoff doubled.

Threading/locks: breaker state is only ever touched from the daemon's
single event loop (PeerClient call sites and the /metrics scrape both
run there), so there is deliberately NO lock here — nothing for the
gubguard lock ranking to order, nothing for raceguard to invert.

All time is injected (`clock`, default time.monotonic) and all jitter
is injected (`rng`), so tests drive the schedule deterministically.

Protocol spec: tools/gubproof/specs/breaker.json — every `state` write
site below must map to a declared edge (checked by `python -m
tools.gubproof`, which also model-checks the probe-admission bound).
"""
from __future__ import annotations

import enum
import random
import time
from typing import Callable, Optional

from gubernator_tpu_torch.core.config import CircuitConfig


class CircuitState(enum.IntEnum):
    """Exported as the `gubernator_circuit_state` gauge value."""

    CLOSED = 0
    OPEN = 1
    HALF_OPEN = 2


class CircuitBreaker:
    """One breaker per peer (owned by net/peer_client.PeerClient)."""

    def __init__(
        self,
        cfg: Optional[CircuitConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
        on_transition: Optional[
            Callable[[CircuitState, CircuitState], None]
        ] = None,
    ) -> None:
        self.cfg = cfg or CircuitConfig()
        self._clock = clock
        self._rng = rng or random.Random()
        # (old_state, new_state) observer — the PeerClient hooks metrics
        # and flight-recorder records here; the breaker itself stays
        # dependency-free.
        self.on_transition = on_transition
        self.state = CircuitState.CLOSED
        self.consecutive_failures = 0
        self.trips = 0  # total CLOSED/HALF_OPEN -> OPEN transitions
        # Consecutive opens without an intervening close: the backoff
        # exponent.  Reset by the success that re-closes the breaker.
        self._streak = 0
        self.opened_at = 0.0
        self.open_until = 0.0
        self._probes = 0  # half-open probe tokens consumed
        # When the last half-open probe token was issued + the probe
        # timeout: past this with all tokens spent and no recorded
        # outcome, the probe is abandoned and the breaker re-opens.
        self._probe_deadline = 0.0

    # -- schedule --------------------------------------------------------
    def backoff_s(self, streak: int) -> float:
        """Jittered exponential backoff for the given open-streak."""
        c = self.cfg
        base = min(
            c.base_backoff_s * (2 ** max(streak - 1, 0)), c.max_backoff_s
        )
        if c.jitter > 0.0:
            base *= 1.0 + c.jitter * (2.0 * self._rng.random() - 1.0)
        return max(base, 1e-3)

    # -- transitions -----------------------------------------------------
    def _set_state(self, new: CircuitState) -> None:
        old = self.state
        if old is new:
            return
        self.state = new
        if self.on_transition is not None:
            self.on_transition(old, new)

    def _open(self) -> None:
        self._streak += 1
        self.trips += 1
        self._probes = 0
        self.opened_at = self._clock()
        self.open_until = self.opened_at + self.backoff_s(self._streak)
        self._set_state(CircuitState.OPEN)

    def record_failure(self) -> None:
        """One peer failure (an `_record_error` event)."""
        self.consecutive_failures += 1
        if self.state is CircuitState.HALF_OPEN:
            self._open()  # failed probe: re-open, backoff doubled
        elif (
            self.state is CircuitState.CLOSED
            and self.consecutive_failures >= self.cfg.failure_threshold
        ):
            self._open()
        # While OPEN, stragglers from in-flight RPCs neither extend the
        # backoff nor double-trip.

    def record_success(self) -> None:
        """One successful RPC.  Closes from any state: a success while
        nominally OPEN (an in-flight RPC from before the trip landing)
        is live evidence the peer is back."""
        self.consecutive_failures = 0
        if self.state is not CircuitState.CLOSED:
            self._streak = 0
            self._probes = 0
            self._set_state(CircuitState.CLOSED)

    def _expire_abandoned_probe(self) -> None:
        """Half-open wedge guard: if every probe token was consumed but
        no outcome ever landed (the gated RPC was cancelled, or its
        error surfaced as something no caller records), re-open after
        `probe_timeout_s` as if the probe had failed — the peer will be
        re-probed after the (doubled) backoff instead of being shed
        forever."""
        if (
            self.state is CircuitState.HALF_OPEN
            and self._probes >= self.cfg.half_open_probes
            and self._clock() >= self._probe_deadline
        ):
            self._open()

    # -- gates -----------------------------------------------------------
    def allow(self) -> bool:
        """Gate ONE RPC attempt; consumes a half-open probe token.
        Called at the point an RPC is actually issued (one batched send
        = one probe)."""
        self._expire_abandoned_probe()
        if self.state is CircuitState.CLOSED:
            return True
        if self.state is CircuitState.OPEN:
            if self._clock() < self.open_until:
                return False
            self._set_state(CircuitState.HALF_OPEN)
        if self._probes >= self.cfg.half_open_probes:
            return False
        self._probes += 1
        self._probe_deadline = self._clock() + self.cfg.probe_timeout_s
        return True

    def would_allow(self) -> bool:
        """Non-consuming peek — the enqueue-time fast-fail gate.  True
        when an attempt reaching the RPC gate could be admitted."""
        self._expire_abandoned_probe()
        if self.state is CircuitState.CLOSED:
            return True
        if self.state is CircuitState.OPEN:
            return self._clock() >= self.open_until
        return self._probes < self.cfg.half_open_probes

    def fast_fail(self) -> bool:
        """True while the breaker is open with backoff still running —
        the signal the degraded-mode fallback keys off (the owner is
        known-dead; retrying the ring would return the same peer)."""
        self._expire_abandoned_probe()
        return (
            self.state is CircuitState.OPEN
            and self._clock() < self.open_until
        )

    # -- observability ---------------------------------------------------
    def state_name(self) -> str:
        return self.state.name.lower()

    def remaining_open_s(self) -> float:
        if self.state is not CircuitState.OPEN:
            return 0.0
        return max(self.open_until - self._clock(), 0.0)

    def snapshot(self) -> dict:
        """The /debug/vars and HealthCheck view."""
        return {
            "state": self.state_name(),
            "trips": self.trips,
            "consecutive_failures": self.consecutive_failures,
            "open_remaining_s": round(self.remaining_open_s(), 3),
        }
