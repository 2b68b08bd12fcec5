"""TorchBackend: the single-table rate-limit engine on one torch device.

The counterpart of gubernator_tpu's `DeviceBackend` hot path (reference
WorkerPool, workers.go:56-664): one device-resident slot table; each
`check()` packs its requests into duplicate-free rounds, applies ALL of them
with ONE dispatch of the serve kernel (ops/kernels/serve_kernel.py) at the
widest batch tier the rounds need, and unpacks the packed responses.
Inactive lanes are no-ops, so the responses of active lanes do not depend on
the tier.

The device is `DeviceConfig.platform` ("cuda" when None).  Without a CUDA
device the constructor raises unless the caller asked for "cpu", where the
kernel's plain version serves.

A lock serializes host calls that touch the table, which preserves the
reference's single-writer discipline (workers.go:19-37) at whole-table
granularity.  Device work is ordered by ONE stream: the backend keeps the
stream that was current when it was built and issues every kernel, copy and
event on it, whatever thread calls (the service's device executor, the fast
lane's pool, the ring runner).  Uploads go through pinned host memory with
non-blocking copies, and each dispatch that is fetched later copies its
responses into pinned memory behind an event recorded right after that copy
(`PendingFetch`), so a fetch waits for its own dispatch only, never for
launches queued after it.

The ring protocol (runtime/ring.py) and the persistent serve mode dispatch
the same kernel: on the card every serve mode runs K1.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.core import clock as clock_mod
from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.core.hashing import bulk_key_hash64
from gubernator_tpu_torch.core.types import RateLimitReq, RateLimitResp, Status
from gubernator_tpu_torch.ops.batch import DeviceBatch, pack_batch_q, pack_requests
from gubernator_tpu_torch.ops.kernels import serve_kernel
from gubernator_tpu_torch.ops.kernels.serve_kernel import (
    new_claim_buffer,
    persistent_serve_step,
)
from gubernator_tpu_torch.ops.state import (
    SlotTable,
    init_table,
    table_from_host,
    table_to_host,
)
from gubernator_tpu_torch.ops.step import RESP_ROWS, CachedRows, store_cached_rows


def resolve_tiers(cfg: DeviceConfig) -> Tuple[int, ...]:
    """Sorted batch tiers; batch_size is always included so tier_of's
    fallback never truncates a full round."""
    tiers = cfg.batch_tiers or (128, cfg.batch_size)
    return tuple(sorted(
        {min(t, cfg.batch_size) for t in tiers} | {cfg.batch_size}
    ))


def tier_of(active: np.ndarray, tiers: Sequence[int]) -> int:
    """Smallest tier that holds this round's active lanes (the packer fills
    lanes contiguously from 0, so the count bounds the highest used lane)."""
    occ = int(np.asarray(active).sum(-1).max())
    for t in tiers:
        if occ <= t:
            return t
    return tiers[-1]


def rounds_to_qs(
    rounds: Sequence[DeviceBatch], tiers: Sequence[int]
) -> np.ndarray:
    """Stack rounds into one int64[k, 12, t] block at the widest tier any of
    them needs."""
    t = max(tier_of(db.active, tiers) for db in rounds)
    return np.stack([pack_batch_q(db)[:, :t] for db in rounds])


class Tally(NamedTuple):
    """Per-call metric increments (gubernator.go:59-113 counters)."""

    checks: int
    over_limit: int
    not_persisted: int
    cache_hits: int = 0


class PendingFetch:
    """Device tensors on their way to the host.

    On the card: non-blocking copies into pinned host memory, issued on the
    backend's stream right after the dispatch that produced the tensors,
    and an event recorded right after the copies; `wait()` waits on that
    event alone.  On the CPU the tensors are the host arrays already."""

    __slots__ = ("_host", "_event")

    def __init__(self, tensors: Sequence[torch.Tensor],
                 stream: Optional["torch.cuda.Stream"]) -> None:
        self._event = None
        if stream is None:
            self._host = list(tensors)
            return
        host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        self._host = host
        self._event = torch.cuda.Event()
        self._event.record(stream)

    def wait(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def _packed_resp_dict(a: np.ndarray) -> Dict[str, np.ndarray]:
    """[9, B] packed response -> named host columns."""
    return {f: a[i] for i, f in enumerate(RESP_ROWS)}


def packed_rounds_to_host(resps) -> List[Dict[str, np.ndarray]]:
    """int64[k, 9, B] responses -> per-round host dicts, in ONE
    device-to-host copy.  `resps` is a device tensor (a blocking copy) or
    a PendingFetch of one (waits on its own event)."""
    if isinstance(resps, PendingFetch):
        host = resps.wait()[0]
    else:
        host = resps.cpu().numpy()
    return [_packed_resp_dict(a) for a in host]


def tally_from_rounds(rounds, round_host) -> Tally:
    """Vectorized Tally over packed rounds (active lanes only)."""
    checks = over = notp = hits = 0
    for db, h in zip(rounds, round_host):
        act = np.asarray(db.active)[..., : h["status"].shape[-1]]
        checks += int(act.sum())
        over += int(((h["status"] == 1) & act).sum())
        notp += int(((h["persisted"] == 0) & act).sum())
        hits += int(((h["found"] != 0) & act).sum())
    return Tally(checks, over, notp, hits)


def unmarshal_responses(
    n_reqs: int,
    errors: Dict[int, str],
    positions: Sequence[tuple],
    round_host: List[Dict[str, np.ndarray]],
) -> Tuple[List[RateLimitResp], Tally]:
    """Per-request RateLimitResp from packed positions (round, lane).

    The requested lanes are gathered with one numpy index per column
    first, so only they are converted to Python ints."""
    pos = np.asarray(positions, dtype=np.int64).reshape(n_reqs, 2)
    ok = np.flatnonzero(pos[:, 0] >= 0)
    cols = {}
    for f in ("status", "limit", "remaining", "reset_time", "persisted",
              "found"):
        v = np.stack([r[f] for r in round_host])[pos[ok, 0], pos[ok, 1]] \
            if len(ok) else np.zeros(0, dtype=np.int64)
        cols[f] = v
    status = cols["status"].tolist()
    limit = cols["limit"].tolist()
    remaining = cols["remaining"].tolist()
    reset_time = cols["reset_time"].tolist()
    out: List[RateLimitResp] = []
    j = 0
    for i in range(n_reqs):
        err = errors.get(i)
        if err is not None:
            out.append(RateLimitResp(error=err))
            continue
        out.append(RateLimitResp(
            status=Status(status[j]),
            limit=limit[j],
            remaining=remaining[j],
            reset_time=reset_time[j],
        ))
        j += 1
    tally = Tally(
        checks=len(ok),
        over_limit=int((cols["status"] == Status.OVER_LIMIT).sum()),
        not_persisted=int((cols["persisted"] == 0).sum()),
        cache_hits=int((cols["found"] != 0).sum()),
    )
    return out, tally


class TorchBackend:
    """Single-table rate-limit engine on one torch device."""

    def __init__(
        self,
        cfg: Optional[DeviceConfig] = None,
        clock=None,
        metrics=None,
    ) -> None:
        self.cfg = cfg or DeviceConfig()
        # Any object with millisecond_now() and now() will do.
        self.clock = clock or clock_mod.default_clock()
        self.metrics = metrics
        self.device = torch.device(self.cfg.device)
        self.stream: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBackend: no CUDA device; pass "
                    "DeviceConfig(platform='cpu') to run on the CPU"
                )
            if self.device.index is None:
                self.device = torch.device(
                    "cuda", torch.cuda.current_device()
                )
            self.stream = torch.cuda.current_stream(self.device)
        self._lock = threading.Lock()
        with self._on_stream():
            self.table: SlotTable = init_table(
                self.cfg.num_slots, self.device
            )
            # The serve kernel's claim words: all INT32_MAX between
            # launches.
            self.claim = (
                new_claim_buffer(self.cfg.num_slots, self.device)
                if self.stream is not None else None
            )
        # K1's lane-list scratch, reused in stream order and grown to the
        # largest dispatch seen (warmup launches every serving shape).
        self._scratch: Optional[torch.Tensor] = None
        self._tiers = resolve_tiers(self.cfg)
        self.checks = 0
        self.over_limit = 0
        self.not_persisted = 0

    def _on_stream(self):
        """Run the caller's device work on the backend's stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _add_tally(self, tally: Tally) -> None:
        with self._lock:
            self.checks += tally.checks
            self.over_limit += tally.over_limit
            self.not_persisted += tally.not_persisted
        m = self.metrics
        if m is not None:
            m.check_counter.inc(tally.checks)
            if tally.over_limit:
                m.over_limit_counter.inc(tally.over_limit)
            if tally.not_persisted:
                m.unexpired_evictions.inc(tally.not_persisted)
            m.cache_access_count.labels(type="hit").inc(tally.cache_hits)
            m.cache_access_count.labels(type="miss").inc(
                tally.checks - tally.cache_hits
            )

    def _observe_step(self, t_start: float) -> None:
        if self.metrics is not None:
            self.metrics.device_step_duration.observe(
                time.monotonic() - t_start
            )

    def _upload(self, a) -> torch.Tensor:
        """Host array -> device tensor: numpy goes through pinned memory
        and a non-blocking copy on the backend's stream (call it inside
        `_on_stream`)."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.stream is None:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _scratch_for(self, k: int, B: int) -> torch.Tensor:
        """K1's scratch for a dispatch of k rounds of B lanes; caller holds
        `_lock`.  Grows the kept buffer when a larger dispatch needs it."""
        words = serve_kernel.scratch_words(self.device, k, B)
        if self._scratch is None or self._scratch.numel() < words:
            self._scratch = None
            try:
                self._scratch = torch.empty(
                    max(words, 1), dtype=torch.int32, device=self.device)
            except torch.OutOfMemoryError as e:
                raise ValueError(
                    f"K1 scratch for {k} rounds of {B} lanes needs "
                    f"{4 * words} bytes on {self.device}; lower "
                    "GUBER_RING_SLOTS x GUBER_RING_ROUNDS or the batch "
                    "size"
                ) from e
        return self._scratch

    def _launch(self, qs, nows, seq) -> Tuple[torch.Tensor, torch.Tensor]:
        """One serve-kernel dispatch on the backend's stream; caller holds
        `_lock`.  Returns the un-synced (int64[k, 9, B], seq + k)."""
        with self._on_stream():
            qs = self._upload(qs).contiguous()
            nows = self._upload(nows).contiguous()
            if not isinstance(seq, torch.Tensor):
                seq = np.asarray(seq, dtype=np.int64)
            seq = self._upload(seq)
            scratch = None
            if self.stream is not None and qs.shape[0]:
                scratch = self._scratch_for(qs.shape[0], qs.shape[2])
            self.table, resps, seq = persistent_serve_step(
                self.table, qs, nows, seq,
                ways=self.cfg.ways, claim=self.claim, scratch=scratch,
            )
        return resps, seq

    def _fetch_later(self, *tensors: torch.Tensor) -> PendingFetch:
        """Start copying `tensors` to the host behind their own event;
        caller holds `_lock`, right after the dispatch that made them."""
        with self._on_stream():
            return PendingFetch(tensors, self.stream)

    # -- hot path --------------------------------------------------------
    def check(
        self,
        reqs: Sequence[RateLimitReq],
        use_cached: Optional[Sequence[bool]] = None,
    ) -> List[RateLimitResp]:
        """Apply a list of checks; returns responses in request order.

        Duplicate keys go to sequential rounds, so same-key requests
        observe each other's effects (workers.go:182-186).  `use_cached[i]`
        marks request i to serve a live GLOBAL broadcast row verbatim
        (gubernator.go:434-447).
        """
        packed = pack_requests(reqs, self.cfg.batch_size, self.clock, use_cached)
        round_host: List[Dict[str, np.ndarray]] = []
        t_start = time.monotonic()
        if packed.rounds:
            with self._lock:
                resps = self._dispatch_rounds_locked(packed.rounds)
                pending = self._fetch_later(resps)
            round_host = packed_rounds_to_host(pending)
        step_s = time.monotonic() - t_start
        if self.metrics is not None:
            self.metrics.device_step_duration.observe(step_s)
            self.metrics.pool_queue_length.observe(len(reqs))
        out, tally = unmarshal_responses(
            len(reqs), packed.errors, packed.positions, round_host
        )
        self._add_tally(tally)
        fr = getattr(self.metrics, "flightrec", None)
        if fr is not None:
            fr.record_batch(
                len(reqs), step_s * 1e3,
                over_limit=tally.over_limit,
                errors=len(packed.errors),
            )
        return out

    def step_rounds(
        self, rounds: Sequence[DeviceBatch], add_tally: bool = True
    ) -> List[Dict[str, np.ndarray]]:
        """Columnar hot path: apply pre-packed [B] rounds; returns host
        response dicts per round (at the launch's tier width)."""
        return self.step_rounds_begin(rounds, add_tally)()

    def step_rounds_begin(
        self, rounds: Sequence[DeviceBatch], add_tally: bool = True
    ):
        """Dispatch the rounds under the lock and return a zero-arg fetch
        closure producing the host response dicts.  The closure waits on
        this dispatch's own copy event, so it may run while later launches
        go out (the pipelined drain)."""
        t_start = time.monotonic()
        pending = None
        if rounds:
            with self._lock:
                pending = self._fetch_later(
                    self._dispatch_rounds_locked(rounds))

        def fetch() -> List[Dict[str, np.ndarray]]:
            if pending is None:
                return []
            host = packed_rounds_to_host(pending)
            if add_tally:
                tally = tally_from_rounds(rounds, host)
                self._add_tally(tally)
                fr = getattr(self.metrics, "flightrec", None)
                if fr is not None:
                    fr.record_batch(
                        tally.checks, (time.monotonic() - t_start) * 1e3,
                        over_limit=tally.over_limit,
                    )
            return host

        return fetch

    def _dispatch_rounds_locked(self, rounds) -> torch.Tensor:
        """Launch the serve kernel once for all `rounds`; caller holds
        `_lock`.  Returns the un-synced int64[k, 9, t] responses."""
        t_start = time.monotonic()
        now = self.clock.millisecond_now()
        qs = rounds_to_qs(rounds, self._tiers)
        nows = np.full(len(rounds), now, dtype=np.int64)
        resps, _ = self._launch(qs, nows, 0)
        self._observe_step(t_start)
        return resps

    # -- ring drain discipline (runtime/ring.py) -------------------------
    def ring_supported(self) -> bool:
        """The ring runner stacks [12, B] rounds along a leading slot axis
        and this backend dispatches such blocks with K1."""
        return True

    def ring_q_shape(self, tb: int) -> tuple:
        """Per-round request-slot shape at batch tier `tb`: [12, tb]."""
        return (12, tb)

    def ring_pack_round(self, db, tb: int) -> np.ndarray:
        """One [B] DeviceBatch -> its ring slot layout [12, tb]."""
        return pack_batch_q(db)[:, :tb]

    def ring_seq_init(self) -> torch.Tensor:
        """A fresh device-resident ring sequence word."""
        with self._on_stream():
            return torch.zeros((), dtype=torch.int64, device=self.device)

    def persistent_serve_dispatch(self, qs, nows, seq, fetch: bool = False):
        """Drain `qs` int64[k, 12, B] stacked rounds in ONE kernel dispatch
        under the lock.  Returns (responses[k, 9, B], seq + k), the
        responses un-synced on the device (the JAX backend's contract); with
        `fetch` (the ring runner), a PendingFetch of (responses, seq + k)
        started right after the dispatch in their place.  The word is a
        fresh tensor per dispatch, never updated in place, so an
        iteration's own word stays readable after the next dispatch takes
        it as input."""
        t_start = time.monotonic()
        with self._lock:
            resps, seq = self._launch(qs, nows, seq)
            out = self._fetch_later(resps, seq) if fetch else resps
        self._observe_step(t_start)
        return out, seq

    ring_step_dispatch = persistent_serve_dispatch

    def ring_mega_dispatch(self, qs, nows, seq, fetch: bool = False):
        """One megaround iteration: `qs` int64[r, s, 12, B] applied in
        order as r*s rounds in ONE dispatch (megaround is a sequential
        scan of rounds).  Returns (responses[r, s, 9, B], seq + r*s), or
        with `fetch` a PendingFetch of the flat [r*s, 9, B] responses and
        the word."""
        r, s = qs.shape[0], qs.shape[1]
        out, seq = self.persistent_serve_dispatch(
            qs.reshape((r * s,) + tuple(qs.shape[2:])), nows.reshape(r * s),
            seq, fetch=fetch)
        if not fetch:
            out = out.reshape((r, s) + tuple(out.shape[1:]))
        return out, seq

    def persistent_serve_supported(self):
        """(ok, reason) for GUBER_SERVE_MODE=persistent.  On the card:
        K1's real build (nvcc at first use) and its owner-block count; a
        failed build raises.  On the CPU there is no kernel to arm, and the
        fast lane degrades to megaround, as the JAX package does where its
        kernel cannot compile."""
        if self.stream is None:
            return False, (
                f"no serve kernel on {self.device.type}: the persistent "
                "mode needs the CUDA kernel (csrc/serve_kernel.cu)"
            )
        serve_kernel.library()
        return True, (
            f"K1 built for {torch.cuda.get_device_name(self.device)}: "
            f"{serve_kernel.owners(self.device)} owner blocks"
        )

    def warmup(self) -> None:
        """Build K1 and launch it once at every batch tier with all-zero
        (inactive) rounds, so no request pays for the nvcc build or the
        module load, then once on the synthetic zero-hit request the JAX
        backend warms with (it leaves the same already-expired row, so the
        two packages' tables stay equal slot for slot); run the
        broadcast-receive upsert once on an empty batch.  Nothing is
        compiled per shape: these launches only load the kernel and size
        its scratch."""
        now = self.clock.millisecond_now()
        packed = pack_requests(
            [RateLimitReq(name="__warmup__", unique_key="w", hits=0,
                          limit=1, duration=1)],
            self.cfg.batch_size, self.clock,
        )
        with self._lock:
            for t in self._tiers:
                self._launch(np.zeros((1, 12, t), dtype=np.int64),
                             np.full(1, now, dtype=np.int64), 0)
            self._dispatch_rounds_locked(packed.rounds)
        self.apply_cached_rows([])
        if self.stream is not None:
            self.stream.synchronize()

    # -- GLOBAL broadcast receive ----------------------------------------
    def apply_cached_rows(self, rows: List[tuple]) -> None:
        """Upsert owner-broadcast statuses: rows of
        (hash_key_str, algorithm, limit, remaining, status, reset_time) —
        the UpdatePeerGlobals receive path (gubernator.go:464-479)."""
        B = self.cfg.batch_size
        now = self.clock.millisecond_now()
        with self._lock, self._on_stream():
            for lo in range(0, max(len(rows), 1), B):
                chunk = rows[lo:lo + B]

                def col(i, dt):
                    return self._upload(
                        np.array([c[i] for c in chunk], dtype=dt))

                cr = CachedRows(
                    key_hash=self._upload(
                        bulk_key_hash64([c[0] for c in chunk])
                        if chunk else np.zeros(0, dtype=np.int64)),
                    algo=col(1, np.int32),
                    limit=col(2, np.int64),
                    remaining=col(3, np.int64),
                    status=col(4, np.int32),
                    reset_time=col(5, np.int64),
                )
                self.table = store_cached_rows(
                    self.table, cr, now, ways=self.cfg.ways)

    # -- state -----------------------------------------------------------
    def snapshot(self) -> Dict[str, np.ndarray]:
        """Copy the whole table to the host, in the snapshot dict format of
        gubernator_tpu's DeviceBackend."""
        with self._lock, self._on_stream():
            return table_to_host(self.table)

    def _install_table(self, arrays: Dict[str, np.ndarray]) -> None:
        """Replace the live table from host arrays (snapshot format)."""
        if arrays["key"].shape[0] != self.cfg.num_slots:
            raise ValueError(
                f"snapshot has {arrays['key'].shape[0]} slots, backend "
                f"expects {self.cfg.num_slots}"
            )
        with self._lock, self._on_stream():
            self.table = table_from_host(arrays, self.device)

    def occupancy(self) -> int:
        with self._lock, self._on_stream():
            return int(self.table.occupancy())
