"""Planet-scale active-active regions: the region carve plane.

The reference ships a cross-DC skeleton and stops (multiregion.go:96-98
"Does nothing for now"; region_picker.go:23-111 only routes) — this
module is the follow-the-sun layer it never grew, composed from the
carve algebra this codebase has proved four times already:

  geography is the gate.  A key's HOME region (a deterministic
  rendezvous pick over the region universe, using the region-picker
  hash) owns truth.  Every OTHER region serves the key from a bounded
  `<unique_key>.region-carve` shadow slot in its own device table at
  `region_fraction x limit` per window — the hot-mirror / local_shadow
  rewrite with a region (not death, pressure, or a remap) as the gate —
  so cluster-wide admission stays within

      limit x (1 + remote_regions x region_fraction)

  whether the WAN is healthy, slow, or partitioned.  No request ever
  waits on a cross-region RPC.

Burned carve hits reconcile to the home region asynchronously on the
`reconcile_ms` cadence over the WAN peer arcs (breaker-gated,
chaos-hooked `PeerClient`s in the region picker), with the GLOBAL
lane's at-most-once discipline: hits aggregate per key, a
provably-unsent flush failure re-queues (shutdown / queue-full /
connect-refused precede any delivery, so the backlog survives a region
partition without double counting), an ambiguous failure drops
(arXiv 1909.08969's caution — a WAN retry that MAY have landed
inflates admission).  `drift` counts the un-reconciled burn backlog;
past `drift_max` the carve refuses new admissions, so a long
partition's divergence stays finite and observable.

Region heal rides the reshard handoff discipline per region link
(tools/gubproof/specs/region.json):

  remote --wan_lost--> degraded --heal--> REGION_PREPARE -> TRANSFER
                                             -> CUTOVER -> remote

PREPARE blocks new carve admissions for the healing region's keys;
TRANSFER flushes the late burns (compensation: the home row absorbs
every admitted carve hit before authority is re-asserted); CUTOVER
revokes region-scaled lease grants and drops carve slots ONLY for keys
whose home moved away — a slot still remote-homed here keeps its
consumed state, so the window's carve budget is spent at most once
(resetting it would hand the region a fresh fraction per heal, the
exact widening the broken model variant in tools/gubproof/models.py
demonstrates).

Threading: `_lock` guards the pending-burn ledger, the reset memory
and the drift counter (never held across an await or device work);
registered in the gubguard lock ranking as `multiregion._lock`.
"""
from __future__ import annotations

import asyncio
import logging
import threading
import time
from dataclasses import replace as dc_replace
from typing import Dict, List, Optional, Tuple

from gubernator_tpu_torch.core.config import RegionConfig
from gubernator_tpu_torch.core.types import (
    Behavior,
    RateLimitReq,
    RateLimitResp,
    Status,
)
from gubernator_tpu_torch.net.peer_client import provably_unsent
from gubernator_tpu_torch.net.replicated_hash import HASH_FUNCTIONS

log = logging.getLogger("gubernator_tpu_torch.multiregion")

# The carve slot's key suffix: remote-homed admission state lives in
# `<unique_key>` + this suffix, its own slot in the local device table,
# never colliding with the real key's rows (the SHADOW_SUFFIX /
# MIRROR_SUFFIX / LEASE_SUFFIX / HANDOFF_SUFFIX convention; enumerated
# in ops/state.SHADOW_PLANES so the gubstat census and the tenant
# ledger see the plane).
REGION_SUFFIX = ".region-carve"

# Region-link states (specs/region.json machine "link").
REGION_REMOTE = "remote"
REGION_DEGRADED = "degraded"
REGION_PREPARE = "region_prepare"
REGION_TRANSFER = "transfer"
REGION_CUTOVER = "cutover"

# Phases during which new carve admissions for the link's keys are
# blocked (the rehome window must not create burns behind the final
# TRANSFER compensation flush).
_REHOME_PHASES = (REGION_PREPARE, REGION_TRANSFER, REGION_CUTOVER)

# TRANSFER compensation rounds before the rehome aborts back to
# degraded (each round is one full WAN flush of the link's backlog).
_TRANSFER_ROUNDS = 5


class RegionLink:
    """This node's view of one REMOTE region: the reconcile backlog,
    the carve-slot reset memory, and the heal state machine."""

    __slots__ = ("region", "state", "rehoming", "pending", "queued_ts",
                 "resets")

    def __init__(self, region: str) -> None:
        self.region = region
        self.state = REGION_REMOTE
        self.rehoming = False
        # base hash_key -> aggregated burn req (summed hits).
        self.pending: Dict[str, RateLimitReq] = {}
        # base hash_key -> monotonic enqueue time of the OLDEST
        # un-flushed burn (the reconcile-lag sample).
        self.queued_ts: Dict[str, float] = {}
        # base hash_key -> zero-hit RESET_REMAINING req that drops the
        # carve slot if the key's home moves away (the shadow-drop
        # discipline; a still-remote-homed slot is never reset).
        self.resets: Dict[str, RateLimitReq] = {}


class RegionManager:
    """The region carve plane (one per service when
    GUBER_REGION_ENABLED)."""

    def __init__(self, service, cfg: RegionConfig, metrics=None) -> None:
        self.s = service
        self.cfg = cfg
        self.metrics = metrics
        self.name = cfg.name or service.cfg.data_center or "local"
        self.fraction = cfg.fraction
        self.reconcile_s = cfg.reconcile_ms / 1000.0
        self.drift_max = cfg.drift_max
        bcfg = service.cfg.behaviors
        self.timeout_s = bcfg.multi_region_timeout_s
        self.batch_limit = bcfg.multi_region_batch_limit
        self._hash_fn = HASH_FUNCTIONS[service.cfg.region_picker_hash]
        self._lock = threading.Lock()
        self._links: Dict[str, RegionLink] = {}
        # Regions ever observed in the WAN picker: a dead region stays
        # in the universe (its keys DEGRADE — an explicit, bounded
        # state — instead of silently re-homing to the survivors).
        self._seen: set = set()
        self._universe_cache: Optional[Tuple[str, ...]] = None
        self._event = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        # Observability mirrors (/debug/vars `region` block, gubtop).
        self.drift_hits = 0
        self.carve_served = 0
        self.drift_refused = 0
        self.reconcile_sends = 0
        self.reconcile_dropped = 0
        self.rehomes = 0

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None

    # ------------------------------------------------------------------
    # home-region picking
    # ------------------------------------------------------------------
    def universe(self) -> Tuple[str, ...]:
        """The region universe every daemon must agree on: the
        configured peer-map regions plus every region ever seen in the
        WAN picker plus self.  Monotonic within a process — membership
        RPC failures (a partition) do not shrink it, so home picks stay
        stable while a region is dark."""
        cached = self._universe_cache
        if cached is not None:
            return cached
        live = set(self.s.region_picker.pickers())
        live.discard("")
        self._seen |= live
        out = tuple(sorted(
            set(self.cfg.peers) | self._seen | {self.name}
        ))
        self._universe_cache = out
        return out

    def home_region(self, key: str) -> str:
        """Deterministic rendezvous pick: every region ranks
        `key@region` with the shared region-picker hash and the top
        rank owns truth — agreement needs only the shared universe, no
        coordination rounds."""
        regions = self.universe()
        if len(regions) <= 1:
            return self.name
        hf = self._hash_fn
        return max(
            regions, key=lambda rg: (hf(f"{key}@{rg}".encode()), rg)
        )

    def remote_home(self, key: str) -> Optional[str]:
        """The key's home region when it is NOT this one (the routing
        test: a non-None answer sends the check to the carve)."""
        home = self.home_region(key)
        return None if home == self.name else home

    def on_remap(self) -> None:
        """The peer set changed: refresh the universe and drop carve
        slots for keys whose home moved (a key re-homed to THIS region
        must not keep a live carve widening its authoritative row)."""
        self._universe_cache = None
        self.universe()
        self.s.spawn_task(self._drop_stale_slots())

    # ------------------------------------------------------------------
    # the carve serve path
    # ------------------------------------------------------------------
    async def serve(
        self, req: RateLimitReq, key: str, home: str
    ) -> RateLimitResp:
        """Serve a remote-homed key from the LOCAL `.region-carve`
        slot at `region_fraction x limit` — zero WAN RTT on the
        request path; the admitted hits reconcile asynchronously."""
        link = self._link(home)
        if self.metrics is not None:
            self.metrics.getratelimit_counter.labels("local").inc()
        reset_ms = self.s._resolve_reset_ms(req)
        if link.state in _REHOME_PHASES:
            # The heal window: admissions pause so the TRANSFER
            # compensation flush is the link's final word.
            return RateLimitResp(
                status=Status.OVER_LIMIT,
                limit=req.limit,
                remaining=0,
                reset_time=reset_ms,
                metadata={"region": home, "region_rehome": link.state},
            )
        if self.drift_hits >= self.drift_max and req.hits:
            # Bounded divergence: past drift_max the carve stops
            # admitting — the partition's over-admission stays finite
            # even if it outlasts every window.
            self.drift_refused += 1
            return RateLimitResp(
                status=Status.OVER_LIMIT,
                limit=req.limit,
                remaining=0,
                reset_time=reset_ms,
                metadata={"region": home, "region_drift": "max"},
            )
        if req.limit <= 0:
            # Deny-all keys stay deny-all on the carve (the
            # local_shadow rule): the max(1, ...) floor keeps small
            # positive limits serviceable, never fails-open a zero.
            return RateLimitResp(
                status=Status.OVER_LIMIT,
                limit=req.limit,
                remaining=0,
                reset_time=reset_ms,
                metadata={"region": home},
            )
        carve_limit = max(1, int(req.limit * self.fraction))
        carve = dc_replace(
            req,
            unique_key=req.unique_key + REGION_SUFFIX,
            limit=carve_limit,
            burst=min(req.burst, carve_limit) if req.burst else 0,
            behavior=Behavior(
                int(req.behavior)
                & ~int(Behavior.GLOBAL)
                & ~int(Behavior.MULTI_REGION)
            ),
        )
        resps = await self.s._check_local([carve])
        resp = resps[0]
        if not resp.error:
            md = dict(resp.metadata) if resp.metadata else {}
            md["region"] = home
            md["region_serve"] = "carve"
            if link.state == REGION_DEGRADED:
                # local_shadow semantics made explicit: the home is
                # unreachable, the answer is the bounded carve.
                md["region_degraded"] = "1"
            resp.metadata = md
            self.carve_served += 1
            if self.metrics is not None:
                self.metrics.region_carve_served.inc()
            with self._lock:
                link.resets.setdefault(key, dc_replace(
                    carve,
                    hits=0,
                    behavior=Behavior(
                        int(carve.behavior)
                        | int(Behavior.RESET_REMAINING)
                    ),
                ))
            if req.hits and resp.status == Status.UNDER_LIMIT:
                # Only ADMITTED hits are burns the home budget must
                # absorb; denied attempts never reconcile.
                self.queue_burn(home, dc_replace(req))
        return resp

    def queue_burn(self, home: str, r: RateLimitReq) -> None:
        """Aggregate an admitted carve burn toward its home region
        (the GlobalManager.queue_hit pattern: summed per key, flushed
        on the reconcile cadence, at-most-once on the wire)."""
        key = r.hash_key()
        link = self._link(home)
        with self._lock:
            cur = link.pending.get(key)
            if cur is not None:
                cur.hits += r.hits
            else:
                link.pending[key] = dc_replace(r)
            link.queued_ts.setdefault(key, time.monotonic())
            self.drift_hits += r.hits
        self._note_drift()
        self._event.set()

    def carve_slot_keys(self) -> List[str]:
        """Hash-key strings of every live carve slot this node
        remembers (the derived-slot census input: each ends with
        REGION_SUFFIX)."""
        with self._lock:
            return [
                r.hash_key()
                for link in self._links.values()
                for r in link.resets.values()
            ]

    # ------------------------------------------------------------------
    # the WAN reconcile lane
    # ------------------------------------------------------------------
    async def _run(self) -> None:
        from gubernator_tpu_torch.runtime.service import window_flush_loop

        await window_flush_loop(
            self._event, self.reconcile_s, self._take_all, self._flush
        )

    def _take_all(self) -> Dict[str, Dict[str, RateLimitReq]]:
        with self._lock:
            out = {
                rg: link.pending
                for rg, link in self._links.items()
                if link.pending
            }
            for rg in out:
                self._links[rg].pending = {}
        return out

    def _take_region(self, region: str) -> Dict[str, RateLimitReq]:
        link = self._link(region)
        with self._lock:
            pending, link.pending = link.pending, {}
        return pending

    async def _flush(
        self, batches: Dict[str, Dict[str, RateLimitReq]]
    ) -> None:
        # Fan out per region — one dark region must not delay the rest.
        await asyncio.gather(*(
            self._flush_region(rg, batch)
            for rg, batch in batches.items()
        ))

    async def _flush_region(
        self, region: str, batch: Dict[str, RateLimitReq]
    ) -> None:
        """Flush one region's aggregated burns to the key owners in
        the home region's ring, at-most-once: provably-unsent failures
        re-queue (and mark the link degraded), ambiguous failures
        drop."""
        link = self._link(region)
        picker = self.s.region_picker.pickers().get(region)
        if picker is None or picker.size() == 0:
            # No WAN arc at all: nothing was sent, provably.
            self._requeue(link, batch)
            self._mark_degraded(link)
            return
        by_peer: Dict[str, Tuple[object, List[RateLimitReq]]] = {}
        for key, r in batch.items():
            fwd = dc_replace(
                r,
                behavior=Behavior(
                    int(r.behavior)
                    & ~int(Behavior.GLOBAL)
                    & ~int(Behavior.MULTI_REGION)
                ),
            )
            peer = picker.get(key)
            addr = peer.info().grpc_address
            by_peer.setdefault(addr, (peer, []))[1].append(fwd)
        healed = False

        async def flush_one(peer, reqs: List[RateLimitReq]) -> bool:
            ok = False
            for lo in range(0, len(reqs), self.batch_limit):
                chunk = reqs[lo:lo + self.batch_limit]
                try:
                    await asyncio.wait_for(
                        peer.get_peer_rate_limits_batch(chunk),
                        timeout=self.timeout_s,
                    )
                    self.reconcile_sends += 1
                    ok = True
                    self._settle(link, chunk)
                except Exception as e:  # noqa: BLE001
                    if provably_unsent(e, peer):
                        # Delivery provably never began — re-queueing
                        # cannot double count, and the backlog (the
                        # drift) survives the partition.
                        log.warning(
                            "re-queueing region burns for '%s': %s",
                            region, e,
                        )
                        self._requeue(
                            link, {r.hash_key(): r for r in chunk}
                        )
                        self._mark_degraded(link)
                    else:
                        # The home MAY have applied the batch: a
                        # re-send would inflate admission
                        # (arXiv 1909.08969).  Drop; the next burn
                        # re-syncs the row.
                        log.error(
                            "dropping region burns for '%s': %s",
                            region, e,
                        )
                        self._drop(link, chunk)
            return ok

        results = await asyncio.gather(
            *(flush_one(p, b) for p, b in by_peer.values())
        )
        healed = any(results)
        if healed and link.state == REGION_DEGRADED and not link.rehoming:
            # A successful WAN delivery while degraded IS the heal
            # signal: start the rehome pipeline.
            self.s.spawn_task(self._rehome(region))

    def _settle(self, link: RegionLink, chunk: List[RateLimitReq]) -> None:
        """A chunk landed at the home region: retire its drift and
        sample the reconcile lag."""
        now = time.monotonic()
        hits = 0
        with self._lock:
            for r in chunk:
                hits += r.hits
                ts = link.queued_ts.pop(r.hash_key(), None)
                if ts is not None and self.metrics is not None:
                    self.metrics.region_reconcile_lag.observe(now - ts)
            self.drift_hits = max(0, self.drift_hits - hits)
        self._note_drift()

    def _requeue(
        self, link: RegionLink, batch: Dict[str, RateLimitReq]
    ) -> None:
        """Provably-unsent burns go back on the backlog (drift already
        counts them; enqueue timestamps survive so lag measures the
        partition, not the retry)."""
        with self._lock:
            for key, r in batch.items():
                cur = link.pending.get(key)
                if cur is not None:
                    cur.hits += r.hits
                else:
                    link.pending[key] = r
        self._event.set()

    def _drop(self, link: RegionLink, chunk: List[RateLimitReq]) -> None:
        """Ambiguous-failure burns leave the ledger: their drift
        retires (we can no longer prove divergence) and the drop is
        counted for the operator."""
        hits = sum(r.hits for r in chunk)
        with self._lock:
            for r in chunk:
                link.queued_ts.pop(r.hash_key(), None)
            self.drift_hits = max(0, self.drift_hits - hits)
        self.reconcile_dropped += hits
        self._note_drift()

    def _mark_degraded(self, link: RegionLink) -> None:
        """The WAN lane to the link's region is provably down: the
        carve keeps serving (bounded local_shadow semantics) and the
        drift backlog accumulates until heal."""
        if link.state == REGION_DEGRADED:
            return
        link.state = REGION_DEGRADED
        if self.metrics is not None:
            self.metrics.region_degraded.inc()
            fr = getattr(self.metrics, "flightrec", None)
            if fr is not None:
                fr.record(
                    "region_degraded", region=link.region,
                    drift=self.drift_hits,
                )
        log.warning(
            "region '%s' degraded: carve serving continues bounded, "
            "burns queue (drift=%d)", link.region, self.drift_hits,
        )

    # ------------------------------------------------------------------
    # heal: REGION_PREPARE -> TRANSFER -> CUTOVER per region link
    # ------------------------------------------------------------------
    async def _rehome(self, region: str) -> None:
        """The healed link re-asserts home authority: block new carve
        admissions (PREPARE), flush the late burns (TRANSFER — the
        cutover compensation), revoke region-scaled leases and drop
        slots whose home moved (CUTOVER), then resume remote serving.
        Carve slots still homed at `region` keep their consumed state:
        the window's fraction is spent at most once per window, not
        once per heal."""
        link = self._link(region)
        if link.rehoming or link.state != REGION_DEGRADED:
            return
        link.rehoming = True
        fr = getattr(self.metrics, "flightrec", None)
        try:
            link.state = REGION_PREPARE
            if fr is not None:
                fr.record(
                    "region_rehome", region=region, phase="prepare",
                    drift=self.drift_hits,
                )
            link.state = REGION_TRANSFER
            for _ in range(_TRANSFER_ROUNDS):
                batch = self._take_region(region)
                if not batch:
                    break
                await self._flush_region(region, batch)
                if link.state == REGION_DEGRADED:
                    return  # the WAN died again mid-transfer
            with self._lock:
                pending = len(link.pending)
            if pending:
                # Compensation could not complete: the link is not
                # healed — fall back and keep the backlog.
                self._mark_degraded(link)
                return
            if fr is not None:
                fr.record(
                    "region_rehome", region=region, phase="transfer",
                    drift=self.drift_hits,
                )
            link.state = REGION_CUTOVER
            if self.s.leases is not None:
                await self.s.leases.drop_rehomed(region)
            await self._drop_stale_slots()
            if fr is not None:
                fr.record(
                    "region_rehome", region=region, phase="cutover",
                    drift=self.drift_hits,
                )
            link.state = REGION_REMOTE
            self.rehomes += 1
            if self.metrics is not None:
                self.metrics.region_rehomes.inc()
            log.info("region '%s' re-homed: drift reconciled", region)
        finally:
            link.rehoming = False

    async def _drop_stale_slots(self) -> None:
        """Drop carve slots for keys whose HOME is no longer the
        link's region (a universe change or a rehome moved them): a
        stale carve must not widen admission at the key's new home —
        the _invalidate_unowned_mirrors discipline."""
        stale: List[RateLimitReq] = []
        with self._lock:
            for rg, link in self._links.items():
                for key in list(link.resets):
                    if self.home_region(key) != rg:
                        stale.append(link.resets.pop(key))
        if not stale:
            return
        try:
            await self.s._check_local(stale)
            fr = getattr(self.metrics, "flightrec", None)
            if fr is not None:
                fr.record("region_slot_drop", keys=len(stale))
        except Exception as e:  # noqa: BLE001 — slots expire anyway
            log.warning("region carve slot drop failed: %s", e)

    # ------------------------------------------------------------------
    # plumbing / observability
    # ------------------------------------------------------------------
    def _link(self, region: str) -> RegionLink:
        link = self._links.get(region)
        if link is None:
            with self._lock:
                link = self._links.setdefault(region, RegionLink(region))
        return link

    def _note_drift(self) -> None:
        if self.metrics is not None:
            self.metrics.region_drift.set(self.drift_hits)

    def debug_vars(self) -> dict:
        with self._lock:
            links = {
                rg: {
                    "state": link.state,
                    "pending_keys": len(link.pending),
                    "pending_hits": sum(
                        r.hits for r in link.pending.values()
                    ),
                    "carve_slots": len(link.resets),
                }
                for rg, link in self._links.items()
            }
            drift = self.drift_hits
        return {
            "name": self.name,
            "universe": list(self.universe()),
            "fraction": self.fraction,
            "drift": drift,
            "drift_max": self.drift_max,
            "drift_refused": self.drift_refused,
            "carve_served": self.carve_served,
            "reconcile_sends": self.reconcile_sends,
            "reconcile_dropped": self.reconcile_dropped,
            "rehomes": self.rehomes,
            "links": links,
        }
