"""Client-side admission leases — the owner side (docs/leases.md).

At millions of users the cheapest RPC is the one never sent
(arXiv:2510.04516): a key's owner grants a holder (a LeasedClient or an
edge daemon) a bounded LOCAL allowance it may burn with zero RPCs,
decoupling admission from state publication (arXiv:2602.11741) exactly
the way the GLOBAL owner/broadcast machinery already does server-side.

The admission algebra is the hot-mirror / local_shadow carve, with the
OWNER holding the slot: every grant for a key burns `allowance =
fraction x limit` hits against a `<unique_key>.lease-grant` shadow slot
whose limit is `max_holders x allowance` per window, so the total
allowance outstanding per window can never exceed
`max_holders x fraction x limit` — and cluster-wide admission for the
key is bounded by `limit x (1 + max_holders x fraction)` even if every
holder partitions away with a full, unreconciled grant.  Burned hits
reconcile asynchronously (Reconcile RPC -> GlobalManager.queue_hit's
at-most-once aggregation; a peer-less single node applies directly), so
the authoritative row converges on the true total; grants are refused
outright while the owner is shedding under SLO pressure
(docs/hotkeys.md — a pressured owner must shed work, not delegate
more admission); and the carve slot is dropped via a zero-hit
RESET_REMAINING check once the last holder releases, reconciles away,
or expires — the shadow-drop discipline, so no stale lease admission
state outlives its holders.

Threading: `_lock` guards only the holder dict (never held across an
await or any device work); registered in the gubguard lock-order
ranking (tools/gubguard/lockorder.py) alongside hotkey._lock — taken
holding nothing, takes nothing while held.

Protocol spec: tools/gubproof/specs/lease.json — every write to a
holder record or the key table must map to a declared lifecycle edge
(grant -> renew -> reconcile -> release/expire), and the explorer
reproduces the `limit x (1 + max_holders x fraction)` bound exactly.
"""
from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, replace as dc_replace
from typing import Dict, List, Optional, Tuple

from gubernator_tpu_torch.core.config import LeaseConfig
from gubernator_tpu_torch.core.types import (
    Behavior,
    LeaseGrant,
    RateLimitReq,
    ReconcileItem,
    Status,
    has_behavior,
)

log = logging.getLogger("gubernator_tpu_torch.lease")

# The carve slot's key suffix: lease allowance state lives in
# `<unique_key>` + this suffix, its own slot in the device table, so it
# never collides with the real key's authoritative or cached rows (the
# SHADOW_SUFFIX / MIRROR_SUFFIX convention).
LEASE_SUFFIX = ".lease-grant"

# Behaviors a lease cannot carry: GLOBAL/MULTI_REGION keys already have
# their own replication planes (and a broadcast would race the carve),
# RESET_REMAINING is a mutation rather than an admission, and Gregorian
# windows reset on calendar boundaries the holder cannot see.  Shared
# with the client SDK (client.LeasedClient) so both sides agree on what
# degrades to per-call checks.
NON_LEASABLE = (
    Behavior.GLOBAL
    | Behavior.MULTI_REGION
    | Behavior.RESET_REMAINING
    | Behavior.DURATION_IS_GREGORIAN
)


@dataclass
class _Holder:
    allowance: int
    expires_ms: int  # unix ms; 0 = placeholder being granted


class _KeyState:
    __slots__ = ("holders", "slot_reset")

    def __init__(self) -> None:
        self.holders: Dict[str, _Holder] = {}
        # Zero-hit RESET_REMAINING req that drops the carve slot once
        # the last holder is gone (filled on first successful grant).
        self.slot_reset: Optional[RateLimitReq] = None


class LeaseManager:
    """Per-node lease grant/reconcile state (owner side)."""

    def __init__(self, service, cfg: LeaseConfig, metrics=None) -> None:
        self.s = service
        self.cfg = cfg
        self.metrics = metrics
        self._lock = threading.Lock()
        self._keys: Dict[str, _KeyState] = {}
        # Observability mirrors (scraped by tests and /debug/vars).
        self.grants = 0
        self.refusals = 0
        self.reconciled_hits = 0
        self.revocations = 0

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _now_ms(self) -> int:
        return int(self.s.clock.now_ns() // 1_000_000)

    def allowance_of(self, limit: int) -> int:
        """One holder's allowance for a limit — the carve unit."""
        return max(1, int(limit * self.cfg.fraction))

    def _leasable_limit(self, req: RateLimitReq) -> int:
        """The budget a grant may carve from.  A key homed in another
        REGION is itself served from this region's bounded
        `.region-carve` slot (docs/multiregion.md), so the lease
        fraction nests inside the region fraction — carving from the
        full limit here would hand holders budget this region never
        owned."""
        rm = getattr(self.s, "regions", None)
        if rm is not None and rm.remote_home(req.hash_key()) is not None:
            return max(1, int(req.limit * rm.fraction))
        return req.limit

    def refusal_for(self, req: RateLimitReq) -> str:
        """Why this limit cannot be leased; empty = leasable."""
        if not req.unique_key:
            return "field 'unique_key' cannot be empty"
        if not req.name:
            return "field 'namespace' cannot be empty"
        if req.limit <= 0:
            return "deny-all limit is not leasable"
        if int(req.behavior) & int(NON_LEASABLE):
            return "non-leasable behavior"
        if not self.s._owns_key(req.hash_key()):
            # A remap can demote this node between the routing split
            # and the grant (or a renewal can land on a demoted owner
            # directly): granting against the stale carve slot here
            # would be UNBOUNDED over-admission — the slot's budget
            # no longer backs the authoritative row, which lives (and
            # is fully spendable) at the new owner.
            return "not the owner of this key"
        sb = self.s.sketch_backend
        if sb is not None and sb.handles(req):
            return "sketch-tier names are not leasable"
        return ""

    def active_holders(self) -> int:
        """Total unexpired holders across keys (the active-grants
        gauge)."""
        now = self._now_ms()
        with self._lock:
            return sum(
                1
                for ks in self._keys.values()
                for h in ks.holders.values()
                if h.expires_ms == 0 or h.expires_ms > now
            )

    def _note_grant(self, outcome: str) -> None:
        if outcome == "granted":
            self.grants += 1
        else:
            self.refusals += 1
        if self.metrics is not None:
            self.metrics.lease_grants.labels(outcome=outcome).inc()

    def _note_revocation(self, reason: str, n: int = 1) -> None:
        self.revocations += n
        if self.metrics is not None:
            self.metrics.lease_revocations.labels(reason=reason).inc(n)

    def _refresh_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.lease_active_grants.set(self.active_holders())

    # ------------------------------------------------------------------
    # grant
    # ------------------------------------------------------------------
    async def grant(
        self, client_id: str, reqs: List[RateLimitReq]
    ) -> List[LeaseGrant]:
        """Grant (or refuse) a lease per request, in request order.

        The holder-count gate runs under the lock with a placeholder
        holder reserved BEFORE the device carve, so concurrent grant
        RPCs cannot overshoot max_holders between check and fill; the
        carve slot's own limit caps total outstanding allowance per
        window regardless."""
        now = self._now_ms()
        out: List[LeaseGrant] = []
        shedding = self.s.shed_level() > 0
        carve_reqs: List[RateLimitReq] = []
        carve_idx: List[int] = []
        reserved: List[Tuple[str, str]] = []  # (hash_key, client_id)
        for req in reqs:
            key = req.hash_key()
            g = LeaseGrant(key=key, limit=req.limit)
            refusal = self.refusal_for(req)
            if refusal:
                g.refusal = refusal
                self._note_grant("refused_behavior")
                out.append(g)
                continue
            if shedding:
                # A pressured owner sheds work; handing out MORE local
                # admission while breaching its SLO would hide exactly
                # the traffic it needs shed (docs/hotkeys.md).
                g.refusal = "owner shedding under pressure"
                self._note_grant("refused_pressure")
                out.append(g)
                continue
            with self._lock:
                ks = self._keys.setdefault(key, _KeyState())
                self._sweep_key_locked(ks, now)
                holder = ks.holders.get(client_id)
                if holder is None and (
                    len(ks.holders) >= self.cfg.max_holders
                ):
                    g.refusal = (
                        "max concurrent holders "
                        f"({self.cfg.max_holders}) reached"
                    )
                    self._note_grant("refused_holders")
                    out.append(g)
                    continue
                if holder is None:
                    # Reserve the holder slot before the await below.
                    ks.holders[client_id] = _Holder(0, 0)
                    reserved.append((key, client_id))
            carve_idx.append(len(out))
            carve_reqs.append(req)
            out.append(g)

        if not carve_reqs:
            self._refresh_gauge()
            return out

        allowances = [
            self.allowance_of(self._leasable_limit(r)) for r in carve_reqs
        ]
        slots = [
            dc_replace(
                r,
                unique_key=r.unique_key + LEASE_SUFFIX,
                hits=a,
                limit=a * self.cfg.max_holders,
                burst=0,
                behavior=Behavior.BATCHING,
            )
            for r, a in zip(carve_reqs, allowances)
        ]
        try:
            resps = await self.s._check_local(slots)
        except Exception as e:  # noqa: BLE001 — refuse, don't 500
            log.warning("lease carve failed: %s", e)
            resps = None
        expires = now + self.cfg.ttl_ms
        for j, i in enumerate(carve_idx):
            req, a, g = carve_reqs[j], allowances[j], out[i]
            key = g.key
            resp = resps[j] if resps is not None else None
            if resp is None or resp.error:
                g.refusal = (
                    f"carve failed: {resp.error}" if resp is not None
                    else "carve failed: device error"
                )
                self._note_grant("refused_error")
                self._unreserve(key, client_id, reserved)
                continue
            if resp.status != Status.UNDER_LIMIT:
                # The window's allowance budget (max_holders x
                # allowance) is spent — refuse until the slot refills.
                g.refusal = "allowance exhausted for this window"
                g.reset_time = resp.reset_time
                self._note_grant("refused_exhausted")
                self._unreserve(key, client_id, reserved)
                continue
            g.allowance = a
            g.expires_at = expires
            g.reset_time = resp.reset_time
            with self._lock:
                ks = self._keys.setdefault(key, _KeyState())
                ks.holders[client_id] = _Holder(a, expires)
                if ks.slot_reset is None:
                    ks.slot_reset = dc_replace(
                        slots[j],
                        hits=0,
                        behavior=Behavior.RESET_REMAINING,
                    )
            self._note_grant("granted")
        self._refresh_gauge()
        return out

    def _unreserve(
        self, key: str, client_id: str,
        reserved: List[Tuple[str, str]],
    ) -> None:
        """Drop a placeholder holder reserved for a grant that was then
        refused (keeps the count gate honest)."""
        if (key, client_id) not in reserved:
            return
        with self._lock:
            ks = self._keys.get(key)
            if ks is None:
                return
            h = ks.holders.get(client_id)
            if h is not None and h.expires_ms == 0 and h.allowance == 0:
                del ks.holders[client_id]
            if not ks.holders and ks.slot_reset is None:
                self._keys.pop(key, None)

    # ------------------------------------------------------------------
    # reconcile
    # ------------------------------------------------------------------
    async def reconcile(
        self, client_id: str, items: List[ReconcileItem]
    ) -> List[LeaseGrant]:
        """Apply burned hits (at-most-once), handle releases, and
        piggyback renewals; one grant per item in item order (allowance
        0 unless the item asked to renew)."""
        now = self._now_ms()
        out: List[LeaseGrant] = []
        burned: List[RateLimitReq] = []
        drops: List[RateLimitReq] = []
        renew_items: List[Tuple[int, RateLimitReq]] = []
        for it in items:
            req = it.request
            key = req.hash_key()
            g = LeaseGrant(key=key, limit=req.limit)
            out.append(g)
            if req.hits > 0:
                burned.append(dc_replace(req))
                self.reconciled_hits += req.hits
                if self.metrics is not None:
                    self.metrics.lease_reconciled_hits.inc(req.hits)
            if it.release:
                with self._lock:
                    ks = self._keys.get(key)
                    if ks is not None and ks.holders.pop(
                        client_id, None
                    ) is not None:
                        self._note_revocation("release")
                        if not ks.holders and ks.slot_reset is not None:
                            drops.append(ks.slot_reset)
                            self._keys.pop(key, None)
                g.refusal = "released"
            elif it.renew:
                renew_items.append((len(out) - 1, dc_replace(req, hits=0)))

        if burned:
            self._apply_burned(burned)
        if drops:
            await self._drop_slots(drops, reason="release")
        if renew_items:
            grants = await self.grant(
                client_id, [r for _, r in renew_items]
            )
            for (i, _), g in zip(renew_items, grants):
                out[i] = g
        self._refresh_gauge()
        return out

    def _apply_burned(self, burned: List[RateLimitReq]) -> None:
        """Converge the authoritative rows on the holders' local burn.

        With peers configured, the hits ride GlobalManager.queue_hit —
        the existing at-most-once aggregation (summed per key, flushed
        on the GLOBAL cadence, provably-unsent-gated re-queueing) whose
        flush lands on the key's owner wherever it is.  A peer-less
        single node applies directly through the local check path (the
        flush would have nowhere to route)."""
        rm = getattr(self.s, "regions", None)
        if rm is not None:
            # Remote-homed burns belong to the region reconcile lane:
            # the WAN flush routes them to the key's HOME region with
            # the same at-most-once discipline (a queue_hit flush
            # would land them on an in-region peer that is not truth).
            rest: List[RateLimitReq] = []
            for r in burned:
                home = rm.remote_home(r.hash_key())
                if home is not None:
                    rm.queue_burn(home, dc_replace(r))
                else:
                    rest.append(r)
            burned = rest
            if not burned:
                return
        if self.s.local_picker.size() == 0:
            reads = [
                dc_replace(
                    r,
                    behavior=Behavior(
                        int(r.behavior)
                        & ~int(Behavior.GLOBAL)
                        & ~int(Behavior.MULTI_REGION)
                    ),
                )
                for r in burned
            ]

            async def apply() -> None:
                try:
                    await self.s._check_local(reads)
                except Exception as e:  # noqa: BLE001
                    log.warning("lease burn apply failed: %s", e)

            self.s.spawn_task(apply())
            return
        for r in burned:
            self.s.global_mgr.queue_hit(r)

    async def _drop_slots(
        self, resets: List[RateLimitReq], reason: str
    ) -> None:
        """Drop carve slots whose last holder is gone: a zero-hit
        RESET_REMAINING removes a token row outright and re-fills a
        leaky one (the shadow-drop mechanics), so the un-burned
        allowance returns to the owner."""
        try:
            await self.s._check_local(resets)
            fr = getattr(self.s.metrics, "flightrec", None)
            if fr is not None:
                fr.record(
                    "lease_slot_drop", keys=len(resets), reason=reason
                )
        except Exception as e:  # noqa: BLE001 — slots expire anyway
            log.warning("lease slot drop (%s) failed: %s", reason, e)

    # ------------------------------------------------------------------
    # remap invalidation (runtime/reshard.py; docs/resharding.md)
    # ------------------------------------------------------------------
    def on_remap(self) -> None:
        """The ring changed: spawn the unowned-grant sweep (fire-and-
        forget on the service loop — set_peers must not await device
        work)."""
        self.s.spawn_task(self.drop_unowned())

    async def drop_unowned(self) -> int:
        """Revoke holder records and drop carve slots for keys this
        node no longer owns.  A demoted owner keeping them would keep
        honoring renewals against a stale carve slot — over-admission
        no algebra bounds, because the new owner grants its own full
        budget in parallel.  Holders renew through the ring and land on
        the new owner (their un-burned allowance stays within the lease
        bound and their burns reconcile there via queue_hit)."""
        drops: List[RateLimitReq] = []
        revoked = 0
        with self._lock:
            for key in list(self._keys):
                if self.s._owns_key(key):
                    continue
                ks = self._keys.pop(key)
                revoked += len(ks.holders)
                if ks.slot_reset is not None:
                    drops.append(ks.slot_reset)
        if revoked:
            self._note_revocation("remap", revoked)
        if drops:
            await self._drop_slots(drops, reason="remap")
        self._refresh_gauge()
        return revoked

    async def drop_rehomed(self, region: str) -> int:
        """Revoke holder records and drop carve slots for keys homed
        in `region` — the region-cutover analog of drop_unowned
        (docs/multiregion.md).  A healed home region re-asserts
        authority over its keys; grants carved here from the region
        fraction must not keep renewing against it, so holders
        re-acquire and their next grant sizes against the live
        topology."""
        rm = getattr(self.s, "regions", None)
        if rm is None:
            return 0
        drops: List[RateLimitReq] = []
        revoked = 0
        with self._lock:
            for key in list(self._keys):
                if rm.home_region(key) != region:
                    continue
                ks = self._keys.pop(key)
                revoked += len(ks.holders)
                if ks.slot_reset is not None:
                    drops.append(ks.slot_reset)
        if revoked:
            self._note_revocation("rehome", revoked)
        if drops:
            await self._drop_slots(drops, reason="rehome")
        self._refresh_gauge()
        return revoked

    # ------------------------------------------------------------------
    # expiry
    # ------------------------------------------------------------------
    def _sweep_key_locked(self, ks: _KeyState, now: int) -> int:
        expired = [
            cid
            for cid, h in ks.holders.items()
            if h.expires_ms and h.expires_ms <= now
        ]
        for cid in expired:
            del ks.holders[cid]
        return len(expired)

    def sweep(self) -> List[RateLimitReq]:
        """Expire overdue holders; returns the slot-reset requests for
        keys whose last holder just lapsed (the caller applies them on
        the device — sync state walk only here, no device work under
        the lock)."""
        now = self._now_ms()
        drops: List[RateLimitReq] = []
        expired = 0
        with self._lock:
            for key in list(self._keys):
                ks = self._keys[key]
                expired += self._sweep_key_locked(ks, now)
                if not ks.holders:
                    if ks.slot_reset is not None:
                        drops.append(ks.slot_reset)
                    self._keys.pop(key, None)
        if expired:
            self._note_revocation("expiry", expired)
        self._refresh_gauge()
        return drops

    async def sweep_apply(self) -> int:
        """One expiry pass including the device-side slot drops — the
        periodic task body (and the deterministic test entrypoint)."""
        drops = self.sweep()
        if drops:
            await self._drop_slots(drops, reason="expiry")
        return len(drops)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def debug_vars(self) -> dict:
        now = self._now_ms()
        with self._lock:
            keys = {
                key: {
                    cid: max(h.expires_ms - now, 0)
                    for cid, h in ks.holders.items()
                }
                for key, ks in self._keys.items()
            }
        return {
            "grants": self.grants,
            "refusals": self.refusals,
            "reconciled_hits": self.reconciled_hits,
            "revocations": self.revocations,
            "keys": keys,
            "config": {
                "fraction": self.cfg.fraction,
                "ttl_ms": self.cfg.ttl_ms,
                "max_holders": self.cfg.max_holders,
            },
        }
