"""Elastic membership: live slot migration on the peers wire.

A peer join/leave remaps the consistent hash.  Without migration every
moved arc's device-resident counters are orphaned — the new owner
starts every limit fresh (a mass limit reset at "millions of users"
scale) while the old owner still holds rows it must never serve again.
This module makes ownership handoff the correctness-critical moment it
is (arXiv:2602.11741): the OLD owner of every moved arc drives a
per-destination state machine

    PREPARE -> DRAIN -> TRANSFER -> CUTOVER -> RELEASE

streaming packed table rows (the ops/state row serialization the
checkpoint plane DMAs) to the new owner over the new `Migrate` RPC,
with the `Handoff` RPC as the control-plane handshake.

Bounded double admission.  Routing flips to the new ring the moment
set_peers lands, so during the handoff window the two owners must agree
on who admits (retrying through ambiguity is how double-admission
compounds — the arXiv:1909.08969 caution already applied to hedging and
retry policy here):

  * PREPARE: the new owner FORWARDS covered checks back to the
    still-authoritative old owner (single authority — zero double
    admission while it is reachable);
  * TRANSFER (announced BEFORE the old owner's atomic extract+clear):
    the new owner serves covered keys from a bounded local
    `<unique_key>.handoff-shadow` carve at `handoff_fraction x limit`
    — each moved key's window admission is bounded by
    `limit x (1 + handoff_fraction)` (the local_shadow / hot-mirror /
    lease algebra with a remap as the gate); the old owner, its rows
    extracted-and-cleared in one in-place call, forwards any
    stale-routed check to the new owner (forwards-or-serves: serve
    while authoritative, forward after);
  * CUTOVER: shadow burns are applied to the freshly injected
    authoritative rows (counters conserved, never inflated — applying
    hits can only lower remaining) and the shadow slots drop via
    zero-hit RESET_REMAINING;
  * crash mid-TRANSFER: the new owner's watchdog self-cutovers after
    `timeout_s` of silence — rows that never arrived start fresh
    (conservative reset, ≤ limit, never inflated) and rows that did
    arrive keep their exact state (Migrate injects only where the key
    is absent, so replayed or late chunks can never clobber newer
    state).

Derived slots are invalidated at the remap, not migrated: the old
owner's LeaseManager drops grants and carve slots for keys it no
longer owns (`LeaseManager.drop_unowned` — holders renew through the
ring and land on the new owner), mirror allowances for keys this node
now owns are reset, and handoff shadows drop at cutover.

Threading: `_lock` guards only the handoff dicts and counters — never
held across an await or any device work (registered in the gubguard
lock ranking next to lease._lock).  Device work rides the service's
single-thread device executor like every other table mutation.

Protocol spec: tools/gubproof/specs/reshard.json — every `phase` write
below must map to a declared edge, and the explorer closes the full
handoff x fault space at small scope (including the reshard+lease
composition), reproducing the admission bounds above exactly.
"""
from __future__ import annotations

import asyncio
import logging
import threading
import time
from dataclasses import dataclass, field, replace as dc_replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from gubernator_tpu_torch.core.config import ReshardConfig
from gubernator_tpu_torch.core.types import (
    Behavior,
    RateLimitReq,
    Status,
)
from gubernator_tpu_torch.runtime import tracing

log = logging.getLogger("gubernator_tpu_torch.reshard")

# The handoff shadow's key suffix (the SHADOW/MIRROR/LEASE convention):
# a covered key served during the window burns a
# `<unique_key>` + this suffix slot in the NEW owner's table, never the
# real key's row.
HANDOFF_SUFFIX = ".handoff-shadow"

# Outbound phases, in order.
PREPARE = "prepare"
DRAIN = "drain"
TRANSFER = "transfer"
CUTOVER = "cutover"
RELEASED = "released"
ABORTED = "aborted"

_PHASE_GAUGE = {
    PREPARE: 1, DRAIN: 2, TRANSFER: 3, CUTOVER: 4, RELEASED: 5,
    ABORTED: 6,
}


def ring_owner_indices(fps: np.ndarray, picker) -> np.ndarray:
    """Peer index per int64 device fingerprint via the picker's cached
    ring arrays — valid on xx rings only, where the ring hash IS the
    XXH64 key fingerprint (the fast router's premise,
    replicated_hash.ring_arrays)."""
    ring, ring_idx, _peers = picker.ring_arrays()
    i = np.searchsorted(
        ring, fps.astype(np.int64).view(np.uint64), side="left"
    )
    i[i == len(ring)] = 0
    return ring_idx[i]


def compute_moved(
    fps: np.ndarray, old_picker: Any, new_picker: Any
) -> Dict[str, np.ndarray]:
    """The remap delta: of the int64 fingerprints `fps` resident on
    THIS node, which were owned by us under `old_picker` but belong to
    another peer under `new_picker`?  Returns {new_owner_addr: fps}.
    Pure function of the two rings (unit-testable without a daemon);
    empty when either ring is empty or we own nothing."""
    out: Dict[str, np.ndarray] = {}
    if not len(fps) or old_picker.size() == 0 or new_picker.size() == 0:
        return out
    old_idx = ring_owner_indices(fps, old_picker)
    old_peers = old_picker.ring_arrays()[2]
    was_mine = np.array(
        [p.info().is_owner for p in old_peers], dtype=bool
    )[old_idx]
    if not was_mine.any():
        return out
    new_idx = ring_owner_indices(fps, new_picker)
    new_peers = new_picker.ring_arrays()[2]
    still_mine = np.array(
        [p.info().is_owner for p in new_peers], dtype=bool
    )[new_idx]
    moved = was_mine & ~still_mine
    if not moved.any():
        return out
    addrs = np.array(
        [p.info().grpc_address for p in new_peers]
    )[new_idx[moved]]
    moved_fps = fps[moved]
    for addr in np.unique(addrs):
        out[str(addr)] = moved_fps[addrs == addr]
    return out


@dataclass
class _Outbound:
    """One old-owner -> new-owner handoff this node is driving."""

    to_addr: str
    epoch: int
    fp_set: set
    n_rows: int
    phase: str = PREPARE
    rows_sent: int = 0
    rows_lost: int = 0
    started_ms: int = 0
    released_ms: int = 0  # clock ms of cutover/abort (linger anchor)


@dataclass
class _Inbound:
    """One handoff this node is receiving."""

    from_addr: str
    epoch: int
    phase: str = PREPARE  # prepare | transfer
    deadline_ms: int = 0  # self-cutover watchdog
    started_ms: int = 0
    injected: int = 0
    skipped: int = 0
    total_rows: int = 0
    # hash_key -> (request template, admitted shadow hits) — applied to
    # the authoritative rows at cutover (counters conserved).
    shadow: Dict[str, Tuple[RateLimitReq, int]] = field(
        default_factory=dict
    )
    # Fingerprints already delivered in this handoff: the replay guard
    # for the merge-on-conflict inject (a re-delivered chunk must not
    # re-subtract consumption).
    seen_fps: set = field(default_factory=set)


class ReshardManager:
    """Per-node live-resharding state (both directions)."""

    def __init__(self, service, cfg: ReshardConfig, metrics=None) -> None:
        self.s = service
        self.cfg = cfg
        self.metrics = metrics
        self._lock = threading.Lock()
        self._outbound: Dict[str, _Outbound] = {}
        self._inbound: Dict[str, _Inbound] = {}
        self._epoch = 0
        self._active = False
        self._minus_me_cache = None
        self.draining = False
        # Test hook: when set, outbound handoffs wait here between the
        # TRANSFER announcement and the extract — lets a test hold the
        # handoff window open deterministically.  None in production.
        self.transfer_gate: Optional[asyncio.Event] = None
        # Observability mirrors (scraped by tests and /debug/vars).
        self.remaps = 0
        self.handoffs_started = 0
        self.handoffs_completed = 0
        self.handoffs_aborted = 0
        self.self_cutovers = 0
        self.rows_sent = 0
        self.rows_received = 0
        self.rows_skipped = 0
        self.rows_lost = 0
        self.shadow_served = 0
        self.forwarded_back = 0

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _now_ms(self) -> int:
        return int(self.s.clock.now_ns() // 1_000_000)

    def active(self) -> bool:
        """True while ANY handoff is live on this node — the compiled
        lane's fallback gate (check_raw steps aside so the object
        path's covered-key routing applies)."""
        return self._active

    def _refresh_active_locked(self) -> None:
        self._active = bool(
            self._outbound or self._inbound or self.draining
        )

    def _me(self) -> str:
        """This node's advertised address per the current ring."""
        for p in self.s.local_picker.peers():
            if p.info().is_owner:
                return p.info().grpc_address
        return ""

    def _set_state_gauge(
        self, addr: str, direction: str, phase: Optional[str]
    ) -> None:
        m = self.metrics
        if m is None:
            return
        try:
            if phase is None:
                m.reshard_state.remove(addr, direction)
            else:
                m.reshard_state.labels(
                    peerAddr=addr, direction=direction
                ).set(_PHASE_GAUGE.get(phase, 0))
        except Exception:  # noqa: BLE001 — label may not exist yet
            pass

    def _count_rows(self, direction: str, n: int) -> None:
        if n and self.metrics is not None:
            self.metrics.reshard_rows.labels(direction=direction).inc(n)

    def _fp_of(self, key: str) -> int:
        from gubernator_tpu_torch.core.hashing import key_hash64

        return int(np.uint64(key_hash64(key)).view(np.int64))

    # ------------------------------------------------------------------
    # remap detection (old-owner side)
    # ------------------------------------------------------------------
    def on_remap(self, old_picker, new_picker) -> None:
        """Service.set_peers computed a remap: find the rows this node
        owned under the OLD ring that belong to someone else under the
        NEW one and drive one handoff per destination.  Spawned as a
        task — the delta needs a device fetch."""
        from gubernator_tpu_torch.net.replicated_hash import xx_64

        self.remaps += 1
        if not self.cfg.enabled:
            return
        if old_picker.size() == 0 or new_picker.size() == 0:
            return
        if (
            old_picker.hash_fn is not xx_64
            or new_picker.hash_fn is not xx_64
        ):
            # fnv interop rings: the device fingerprint is not the ring
            # hash, so the delta cannot be computed from the table.
            log.warning(
                "resharding disabled on non-xx picker hash: a remap "
                "orphans moved counters (the legacy reset behavior)"
            )
            return
        self.s.spawn_task(self._remap_task(old_picker, new_picker))

    async def _remap_task(self, old_picker, new_picker) -> None:
        loop = asyncio.get_running_loop()
        try:
            fps = await loop.run_in_executor(
                self.s._dev_executor, self._owned_bucket_fps
            )
        except RuntimeError:
            # The service closed between the remap and this task (the
            # device executor is gone) — nothing left to migrate.
            return
        moved = compute_moved(fps, old_picker, new_picker)
        if not moved:
            return
        n = int(sum(len(v) for v in moved.values()))
        log.info(
            "remap: %d row(s) moved across %d destination(s)",
            n, len(moved),
        )
        fr = getattr(self.s.metrics, "flightrec", None)
        if fr is not None:
            fr.record(
                "reshard_remap", rows=n, destinations=len(moved)
            )
        await asyncio.gather(*(
            self._run_handoff(addr, dest_fps)
            for addr, dest_fps in moved.items()
        ))

    def _owned_bucket_fps(self) -> np.ndarray:
        """Live KIND_BUCKET fingerprints resident on this node, minus
        the derived slots this node can invalidate locally (lease
        carves, mirror allowances, degraded/handoff shadows) — those
        re-home by re-creation at their new homes, never by copy."""
        from gubernator_tpu_torch.ops.state import KIND_BUCKET

        keys, kinds, expires = self.s.backend.key_snapshot()
        now = self._now_ms()
        live = (keys != 0) & (expires > now) & (kinds == KIND_BUCKET)
        fps = keys[live]
        derived = self.s.derived_slot_fps()
        if len(derived):
            fps = fps[~np.isin(fps, derived)]
        return fps

    # ------------------------------------------------------------------
    # outbound state machine
    # ------------------------------------------------------------------
    async def _run_handoff(self, to_addr: str, fps: np.ndarray) -> None:
        peer = self.s.local_picker.get_by_address(to_addr)
        if peer is None:
            return
        me = self._me()
        with self._lock:
            self._epoch += 1
            epoch = self._epoch
            ob = _Outbound(
                to_addr=to_addr, epoch=epoch,
                fp_set={int(f) for f in fps}, n_rows=len(fps),
                started_ms=self._now_ms(),
            )
            self._outbound[to_addr] = ob
            self._refresh_active_locked()
            self.handoffs_started += 1
        self._set_state_gauge(to_addr, "outbound", PREPARE)
        t0 = time.monotonic()
        outcome = "aborted"
        try:
            with tracing.span(
                "reshard.handoff", parent=None,
                peer=to_addr, rows=len(fps), epoch=epoch,
            ):
                accepted, state = await self._handoff_rpc(
                    peer, me, epoch, PREPARE
                )
                if not accepted:
                    raise RuntimeError(
                        f"prepare rejected by {to_addr}: {state}"
                    )
                # DRAIN: a no-op barrier through the local batcher —
                # every batch queued before this point has applied, so
                # the extract below sees their effects.
                ob.phase = DRAIN
                self._set_state_gauge(to_addr, "outbound", DRAIN)
                await self.s._local_batcher.check([], None)
                # Announce TRANSFER first: from the receiver's ack
                # onward it serves covered keys from the bounded
                # shadow, so the extract+clear below can never strand a
                # check between two absent rows.
                accepted, state = await self._handoff_rpc(
                    peer, me, epoch, TRANSFER, total_rows=len(fps)
                )
                if not accepted:
                    raise RuntimeError(
                        f"transfer rejected by {to_addr}: {state}"
                    )
                ob.phase = TRANSFER
                self._set_state_gauge(to_addr, "outbound", TRANSFER)
                if self.transfer_gate is not None:
                    await self.transfer_gate.wait()
                await self._transfer_rows(peer, ob, me, fps)
                ob.phase = CUTOVER
                self._set_state_gauge(to_addr, "outbound", CUTOVER)
                accepted, _state = await self._handoff_rpc(
                    peer, me, epoch, CUTOVER, retries=5
                )
                if not accepted:
                    raise RuntimeError(f"cutover rejected by {to_addr}")
            outcome = "completed"
            self.handoffs_completed += 1
            window_s = time.monotonic() - t0
            if self.metrics is not None:
                self.metrics.reshard_window_duration.observe(window_s)
            fr = getattr(self.s.metrics, "flightrec", None)
            if fr is not None:
                fr.record(
                    "reshard_cutover", peer=to_addr, epoch=epoch,
                    rows=ob.rows_sent, lost=ob.rows_lost,
                    window_ms=round(window_s * 1e3, 3),
                )
            log.info(
                "handoff to %s complete: %d row(s) in %.1fms (%d lost)",
                to_addr, ob.rows_sent, window_s * 1e3, ob.rows_lost,
            )
        except Exception as e:  # noqa: BLE001 — degrade to legacy reset
            self.handoffs_aborted += 1
            log.warning(
                "handoff to %s aborted in %s: %s — moved counters for "
                "%d row(s) degrade to the legacy reset",
                to_addr, ob.phase, e, ob.n_rows - ob.rows_sent,
            )
        finally:
            with self._lock:
                ob.phase = RELEASED if outcome == "completed" else ABORTED
                ob.released_ms = self._now_ms()
            self._set_state_gauge(to_addr, "outbound", ob.phase)
            if self.metrics is not None:
                self.metrics.reshard_handoffs.labels(
                    direction="outbound", outcome=outcome
                ).inc()

    async def _handoff_rpc(
        self, peer, me: str, epoch: int, phase: str,
        total_rows: int = 0, retries: int = 2,
    ) -> Tuple[bool, str]:
        last: Optional[Exception] = None
        for attempt in range(retries + 1):
            try:
                return await peer.handoff(
                    me, epoch, phase, total_rows=total_rows
                )
            except Exception as e:  # noqa: BLE001
                last = e
                await asyncio.sleep(min(0.1 * (2 ** attempt), 1.0))
        raise RuntimeError(f"handoff({phase}) failed: {last}")

    async def _transfer_rows(
        self, peer, ob: _Outbound, me: str, fps: np.ndarray
    ) -> None:
        """Extract+clear moved rows chunk by chunk (each chunk one
        atomic in-place migrate_extract under backend._lock) and stream them to
        the new owner.  A chunk that cannot be delivered before the
        handoff deadline is LOST — the new owner's watchdog will
        self-cutover and those keys conservatively reset."""
        from gubernator_tpu_torch.proto import peers_pb2

        loop = asyncio.get_running_loop()
        chunk = self.cfg.chunk_rows
        deadline = time.monotonic() + self.cfg.timeout_s
        backend = self.s.backend
        keymap = getattr(backend, "_keymap", None)
        n_chunks = max((len(fps) + chunk - 1) // chunk, 1)
        for ci in range(n_chunks):
            part = fps[ci * chunk:(ci + 1) * chunk]
            packed, rf = await loop.run_in_executor(
                self.s._dev_executor,
                lambda p=part: backend.migrate_extract_rows(p),
            )
            found = packed[0] != 0
            if not found.any() and ci + 1 < n_chunks:
                continue
            rows = peers_pb2.MigratedRows(
                key_hash=part[found].tolist(),
                algo=packed[2][found].tolist(),
                limit=packed[3][found].tolist(),
                duration=packed[4][found].tolist(),
                remaining=packed[5][found].tolist(),
                remaining_f=rf[found].tolist(),
                t0=packed[6][found].tolist(),
                status=packed[7][found].tolist(),
                burst=packed[8][found].tolist(),
                expire_at=packed[9][found].tolist(),
            )
            if keymap is not None:
                with backend._keymap_lock:
                    rows.keys.extend(
                        keymap.get(
                            int(np.int64(f).view(np.uint64)), ""
                        )
                        for f in part[found]
                    )
            n = len(rows.key_hash)
            final = ci + 1 >= n_chunks
            sent = False
            attempt = 0
            while time.monotonic() < deadline:
                try:
                    await peer.migrate(me, ob.epoch, rows, final=final)
                    sent = True
                    break
                except Exception as e:  # noqa: BLE001
                    attempt += 1
                    log.debug(
                        "migrate chunk to %s failed (attempt %d): %s",
                        ob.to_addr, attempt, e,
                    )
                    await asyncio.sleep(
                        min(0.05 * (2 ** min(attempt, 6)), 1.0)
                    )
            if sent:
                ob.rows_sent += n
                self.rows_sent += n
                self._count_rows("sent", n)
            else:
                ob.rows_lost += n
                self.rows_lost += n
                self._count_rows("lost", n)
                raise RuntimeError(
                    f"transfer deadline: {n} row(s) undeliverable to "
                    f"{ob.to_addr}"
                )

    def reroute_target(self, key: str) -> Optional[str]:
        """Where the old owner sends a check it must no longer serve:
        the destination of the handoff covering `key`, once its rows
        are gone (TRANSFER onward).  None = serve normally (we are
        still authoritative, or the key never moved)."""
        if not self._active:
            return None
        fp = self._fp_of(key)
        with self._lock:
            for ob in self._outbound.values():
                if ob.phase in (TRANSFER, CUTOVER, RELEASED) and (
                    fp in ob.fp_set
                ):
                    return ob.to_addr
        return None

    # ------------------------------------------------------------------
    # inbound (new-owner side)
    # ------------------------------------------------------------------
    async def on_handoff(
        self, from_addr: str, epoch: int, phase: str, total_rows: int
    ) -> Tuple[bool, str]:
        """The Handoff RPC receive path."""
        if not self.cfg.enabled:
            return False, "resharding disabled"
        now = self._now_ms()
        deadline = now + int(self.cfg.timeout_s * 1000)
        if phase == PREPARE:
            with self._lock:
                ib = self._inbound.get(from_addr)
                if ib is not None and ib.epoch > epoch:
                    return False, f"stale epoch {epoch} < {ib.epoch}"
                self._inbound[from_addr] = _Inbound(
                    from_addr=from_addr, epoch=epoch,
                    deadline_ms=deadline, started_ms=now,
                )
                self._refresh_active_locked()
            self._set_state_gauge(from_addr, "inbound", PREPARE)
            return True, PREPARE
        with self._lock:
            ib = self._inbound.get(from_addr)
            if ib is None or ib.epoch != epoch:
                stale = ib.epoch if ib is not None else None
                # An unmatched cutover is idempotent-accept: the sender
                # only needs to know it may release.
                if phase in (CUTOVER, "abort"):
                    return True, "no such handoff (already finalized)"
                return False, f"unknown handoff (have epoch {stale})"
            if phase == TRANSFER:
                ib.phase = TRANSFER
                ib.total_rows = int(total_rows)
                ib.deadline_ms = deadline
        if phase == TRANSFER:
            self._set_state_gauge(from_addr, "inbound", TRANSFER)
            return True, TRANSFER
        if phase == CUTOVER:
            await self._finalize_inbound(ib, outcome="completed")
            return True, CUTOVER
        if phase == "abort":
            await self._finalize_inbound(ib, outcome="aborted")
            return True, "aborted"
        return False, f"unknown phase {phase!r}"

    async def on_migrate(
        self, from_addr: str, epoch: int, rows, final: bool
    ) -> Tuple[int, int]:
        """The Migrate RPC receive path: inject one chunk of packed
        rows (only where the key is not already resident).  Raises
        KeyError for an unknown/stale handoff so the servicer maps it
        to FAILED_PRECONDITION."""
        with self._lock:
            ib = self._inbound.get(from_addr)
            if ib is None or ib.epoch != epoch:
                raise KeyError(
                    f"no active handoff from {from_addr} at epoch "
                    f"{epoch}"
                )
            ib.deadline_ms = self._now_ms() + int(
                self.cfg.timeout_s * 1000
            )
            # Replay guard: injection MERGES conflicting rows (the
            # receiver may have served a moved key before its row
            # arrived), so a re-delivered chunk — the sender retries on
            # any ambiguous failure — must not re-subtract.  Only
            # first-delivery fingerprints reach the device.
            fresh = [
                j for j, fp in enumerate(rows.key_hash)
                if fp not in ib.seen_fps
            ]
            ib.seen_fps.update(rows.key_hash)
        n = len(rows.key_hash)
        if n == 0:
            return 0, 0
        if not fresh:
            return 0, n
        cols = {
            "key_hash": np.array(rows.key_hash, dtype=np.int64)[fresh],
            "algo": np.array(rows.algo, dtype=np.int32)[fresh],
            "limit": np.array(rows.limit, dtype=np.int64)[fresh],
            "duration": np.array(rows.duration, dtype=np.int64)[fresh],
            "remaining": np.array(
                rows.remaining, dtype=np.int64
            )[fresh],
            "remaining_f": np.array(
                rows.remaining_f, dtype=np.float64
            )[fresh],
            "t0": np.array(rows.t0, dtype=np.int64)[fresh],
            "status": np.array(rows.status, dtype=np.int32)[fresh],
            "burst": np.array(rows.burst, dtype=np.int64)[fresh],
            "expire_at": np.array(
                rows.expire_at, dtype=np.int64
            )[fresh],
        }
        loop = asyncio.get_running_loop()
        injected, skipped = await loop.run_in_executor(
            self.s._dev_executor,
            lambda: self.s.backend.migrate_inject_rows(cols),
        )
        skipped += n - len(fresh)
        if rows.keys:
            keymap = getattr(self.s.backend, "_keymap", None)
            if keymap is not None:
                with self.s.backend._keymap_lock:
                    for fp, key in zip(rows.key_hash, rows.keys):
                        if key:
                            keymap[
                                int(np.int64(fp).view(np.uint64))
                            ] = key
        with self._lock:
            ib.injected += injected
            ib.skipped += skipped
        self.rows_received += injected
        self.rows_skipped += skipped
        self._count_rows("injected", injected)
        self._count_rows("skipped", skipped)
        return injected, skipped

    def _ring_without_me(self) -> Any:
        """The current ring minus this node — on a JOINER (which never
        saw the old ring) the owner of a moved key under this ring IS
        its old owner, because adding a peer's vnodes only reassigns
        arcs TO that peer.  Cached per picker swap."""
        pick = self.s.local_picker
        cached = self._minus_me_cache
        if cached is not None and cached[0] is pick:
            return cached[1]
        sub = pick.new()
        for p in pick.peers():
            if not p.info().is_owner:
                sub.add(p)
        self._minus_me_cache = (pick, sub)
        return sub

    def inbound_covering(self, key: str) -> Optional[_Inbound]:
        """The active inbound handoff covering `key`, if any.  The
        sending old owner is identified three ways, matching the three
        membership shapes a receiver can be in: the key's owner under
        the PREVIOUS ring (an existing daemon after a leave landed),
        under the CURRENT ring (a draining leaver still in the set),
        or under the current ring WITHOUT this node (a joiner, which
        never saw the old ring)."""
        if not self._inbound:
            return None
        owners = []
        prev = getattr(self.s, "_prev_picker", None)
        for picker in (
            prev, self.s.local_picker, self._ring_without_me()
        ):
            if picker is None or picker.size() == 0:
                continue
            try:
                owners.append(picker.get(key).info().grpc_address)
            except Exception:  # noqa: BLE001 — PoolEmptyError
                continue
        if not owners:
            return None
        with self._lock:
            for addr in owners:
                ib = self._inbound.get(addr)
                if ib is not None:
                    return ib
        return None

    async def serve_covered(
        self, req: RateLimitReq, key: str, ib: _Inbound
    ):
        """Serve a check for a covered key during the handoff window.

        PREPARE: forward back to the still-authoritative old owner
        (single authority — no double admission while reachable).
        TRANSFER, or PREPARE with the old owner unreachable: serve the
        bounded `.handoff-shadow` carve — this is the window's entire
        double-admission budget (handoff_fraction x limit)."""
        from gubernator_tpu_torch.core.types import RateLimitResp

        with self._lock:
            live = self._inbound.get(ib.from_addr) is ib
        if not live:
            # CUTOVER landed between routing and serving: this node is
            # fully authoritative now — serve the real row.
            return (await self.s._check_local([req]))[0]
        if ib.phase == PREPARE:
            peer = self.s.local_picker.get_by_address(ib.from_addr)
            if peer is not None and not peer.info().is_owner:
                try:
                    with tracing.span(
                        "reshard.forward_back", require_parent=True,
                        peer=ib.from_addr,
                    ):
                        resp = await peer.get_peer_rate_limit(req)
                    self.forwarded_back += 1
                    md = dict(resp.metadata) if resp.metadata else {}
                    md["reshard"] = "forwarded"
                    md["owner"] = ib.from_addr
                    resp.metadata = md
                    return resp
                except Exception:  # noqa: BLE001 — degrade to shadow
                    pass
        self.shadow_served += 1
        if self.metrics is not None:
            self.metrics.reshard_shadow_served.inc()
        reset_ms = self.s._resolve_reset_ms(req)
        if req.limit <= 0:
            # Deny-all keys stay deny-all during a handoff (the
            # local_shadow rule).
            return RateLimitResp(
                status=Status.OVER_LIMIT, limit=req.limit, remaining=0,
                reset_time=reset_ms,
                metadata={"reshard": "handoff-shadow",
                          "owner": ib.from_addr},
            )
        frac_limit = max(1, int(req.limit * self.cfg.handoff_fraction))
        shadow = dc_replace(
            req,
            unique_key=req.unique_key + HANDOFF_SUFFIX,
            limit=frac_limit,
            burst=min(req.burst, frac_limit) if req.burst else 0,
            behavior=Behavior(
                int(req.behavior)
                & ~int(Behavior.GLOBAL)
                & ~int(Behavior.MULTI_REGION)
            ),
        )
        resps = await self.s._check_local([shadow])
        resp = resps[0]
        if not resp.error:
            md = dict(resp.metadata) if resp.metadata else {}
            md["reshard"] = "handoff-shadow"
            md["owner"] = ib.from_addr
            resp.metadata = md
            if req.hits and resp.status == Status.UNDER_LIMIT:
                # Conservation ledger: admitted shadow hits are applied
                # to the authoritative row at cutover.  If CUTOVER
                # finalized while this check's shadow step was in
                # flight, the ledger snapshot missed this burn (and the
                # step may have re-created the just-dropped slot) —
                # compensate directly: apply the hit to the now-
                # authoritative row and re-drop the shadow slot.
                late = False
                with self._lock:
                    if self._inbound.get(ib.from_addr) is ib:
                        cur = ib.shadow.get(key)
                        burned = (
                            cur[1] if cur is not None else 0
                        ) + int(req.hits)
                        ib.shadow[key] = (
                            dc_replace(req, hits=0), burned
                        )
                    else:
                        late = True
                if late:
                    self.s.spawn_task(self._late_burn(req))
        return resp

    async def _late_burn(self, req: RateLimitReq) -> None:
        """A shadow admission that raced CUTOVER: conserve it by
        applying the hits to the authoritative row and re-dropping the
        shadow slot the racing step may have re-created."""
        strip = Behavior(
            int(req.behavior)
            & ~int(Behavior.GLOBAL)
            & ~int(Behavior.MULTI_REGION)
        )
        frac_limit = max(1, int(req.limit * self.cfg.handoff_fraction))
        try:
            await self.s._check_local([
                dc_replace(req, behavior=strip),
                dc_replace(
                    req,
                    unique_key=req.unique_key + HANDOFF_SUFFIX,
                    limit=frac_limit,
                    burst=0,
                    hits=0,
                    behavior=Behavior(
                        int(strip) | int(Behavior.RESET_REMAINING)
                    ),
                ),
            ])
        except Exception as e:  # noqa: BLE001 — slots expire anyway
            log.warning("late shadow-burn reconcile failed: %s", e)

    async def _finalize_inbound(
        self, ib: _Inbound, outcome: str
    ) -> None:
        """CUTOVER: the new owner becomes authoritative.  Apply the
        window's shadow burns to the (now injected) authoritative rows
        — applying hits only ever LOWERS remaining, so conservation
        can never inflate admission — and drop the shadow slots."""
        with self._lock:
            cur = self._inbound.get(ib.from_addr)
            if cur is not ib:
                return  # already finalized
            del self._inbound[ib.from_addr]
            self._refresh_active_locked()
            shadow = dict(ib.shadow)
        self._set_state_gauge(ib.from_addr, "inbound", None)
        burns: List[RateLimitReq] = []
        drops: List[RateLimitReq] = []
        for _key, (tmpl, burned) in shadow.items():
            strip = Behavior(
                int(tmpl.behavior)
                & ~int(Behavior.GLOBAL)
                & ~int(Behavior.MULTI_REGION)
            )
            if burned > 0:
                burns.append(
                    dc_replace(tmpl, hits=burned, behavior=strip)
                )
            frac_limit = max(
                1, int(tmpl.limit * self.cfg.handoff_fraction)
            )
            drops.append(dc_replace(
                tmpl,
                unique_key=tmpl.unique_key + HANDOFF_SUFFIX,
                limit=frac_limit,
                burst=0,
                hits=0,
                behavior=Behavior(
                    int(strip) | int(Behavior.RESET_REMAINING)
                ),
            ))
        try:
            if burns:
                await self.s._check_local(burns)
            if drops:
                await self.s._check_local(drops)
        except Exception as e:  # noqa: BLE001 — slots expire anyway
            log.warning("handoff shadow reconcile failed: %s", e)
        if outcome == "self_cutover":
            self.self_cutovers += 1
        if self.metrics is not None:
            self.metrics.reshard_handoffs.labels(
                direction="inbound", outcome=outcome
            ).inc()
        fr = getattr(self.s.metrics, "flightrec", None)
        if fr is not None:
            fr.record(
                "reshard_cutover_inbound", peer=ib.from_addr,
                epoch=ib.epoch, outcome=outcome,
                injected=ib.injected, skipped=ib.skipped,
                shadow_keys=len(shadow),
            )
        log.info(
            "inbound handoff from %s finalized (%s): injected=%d "
            "skipped=%d shadow_keys=%d",
            ib.from_addr, outcome, ib.injected, ib.skipped, len(shadow),
        )

    # ------------------------------------------------------------------
    # watchdog + drain
    # ------------------------------------------------------------------
    async def check_timeouts(self) -> int:
        """One watchdog pass: self-cutover inbound handoffs whose old
        owner went silent (crash mid-TRANSFER — missing rows start
        fresh: conservative reset, never inflated), and forget released
        outbound records past the stale-router linger.  Returns the
        number of self-cutovers."""
        now = self._now_ms()
        overdue: List[_Inbound] = []
        with self._lock:
            for ib in self._inbound.values():
                if ib.deadline_ms and now >= ib.deadline_ms:
                    overdue.append(ib)
            linger = int(self.cfg.release_linger_s * 1000)
            done = [
                addr for addr, ob in self._outbound.items()
                if ob.phase in (RELEASED, ABORTED)
                and now - ob.released_ms >= linger
            ]
            for addr in done:
                del self._outbound[addr]
            self._refresh_active_locked()
        for addr in done:
            self._set_state_gauge(addr, "outbound", None)
        for ib in overdue:
            log.warning(
                "inbound handoff from %s timed out (%d/%s rows "
                "arrived) — self-cutover, missing rows reset",
                ib.from_addr, ib.injected,
                ib.total_rows or "?",
            )
            await self._finalize_inbound(ib, outcome="self_cutover")
        return len(overdue)

    async def drain_all(self) -> int:
        """Graceful scale-down (the autoscaler's SIGTERM/preStop hook):
        migrate EVERY row this node owns to its next owner — the ring
        without this node — then keep forwarding stale-routed traffic
        until the caller closes the daemon.  Returns rows shipped."""
        pick = self.s.local_picker
        if pick.size() <= 1:
            return 0
        without_me = pick.new()
        for p in pick.peers():
            if not p.info().is_owner:
                without_me.add(p)
        if without_me.size() == 0:
            return 0
        self.draining = True
        with self._lock:
            self._refresh_active_locked()
        loop = asyncio.get_running_loop()
        fps = await loop.run_in_executor(
            self.s._dev_executor, self._owned_bucket_fps
        )
        moved = compute_moved(fps, pick, without_me)
        sent_before = self.rows_sent
        if moved:
            await asyncio.gather(*(
                self._run_handoff(addr, dest_fps)
                for addr, dest_fps in moved.items()
            ))
        return self.rows_sent - sent_before

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def debug_vars(self) -> dict:
        with self._lock:
            outbound = {
                addr: {
                    "phase": ob.phase, "epoch": ob.epoch,
                    "rows": ob.n_rows, "sent": ob.rows_sent,
                    "lost": ob.rows_lost,
                }
                for addr, ob in self._outbound.items()
            }
            inbound = {
                addr: {
                    "phase": ib.phase, "epoch": ib.epoch,
                    "injected": ib.injected, "skipped": ib.skipped,
                    "total_rows": ib.total_rows,
                    "shadow_keys": len(ib.shadow),
                }
                for addr, ib in self._inbound.items()
            }
        return {
            "active": self._active,
            "draining": self.draining,
            "remaps": self.remaps,
            "handoffs": {
                "started": self.handoffs_started,
                "completed": self.handoffs_completed,
                "aborted": self.handoffs_aborted,
                "self_cutovers": self.self_cutovers,
            },
            "rows": {
                "sent": self.rows_sent,
                "received": self.rows_received,
                "skipped": self.rows_skipped,
                "lost": self.rows_lost,
            },
            "shadow_served": self.shadow_served,
            "forwarded_back": self.forwarded_back,
            "outbound": outbound,
            "inbound": inbound,
            "config": {
                "handoff_fraction": self.cfg.handoff_fraction,
                "chunk_rows": self.cfg.chunk_rows,
                "timeout_s": self.cfg.timeout_s,
            },
        }

    def health_lines(self) -> List[str]:
        """Advisory HealthCheck lines while migrations are in flight
        (the daemon IS serving; status stays connectivity-driven)."""
        out: List[str] = []
        with self._lock:
            for addr, ob in self._outbound.items():
                if ob.phase not in (RELEASED, ABORTED):
                    out.append(
                        f"Resharding: handing off {ob.n_rows} row(s) "
                        f"to {addr} ({ob.phase})"
                    )
            for addr, ib in self._inbound.items():
                out.append(
                    f"Resharding: receiving from {addr} "
                    f"({ib.phase}, {ib.injected} injected)"
                )
        if self.draining:
            out.append("Resharding: node draining for shutdown")
        return out
