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

Synchronous by design: a lock serializes table mutations, which preserves
the reference's single-writer discipline (workers.go:19-37) at whole-table
granularity.
"""
from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.core import clock as clock_mod
from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.core.types import RateLimitReq, RateLimitResp, Status
from gubernator_tpu_torch.ops.batch import DeviceBatch, pack_batch_q, pack_requests
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
from gubernator_tpu_torch.ops.step import RESP_ROWS


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


def _packed_resp_dict(a: np.ndarray) -> Dict[str, np.ndarray]:
    """[9, B] packed response -> named host columns."""
    return {f: a[i] for i, f in enumerate(RESP_ROWS)}


def packed_rounds_to_host(resps: torch.Tensor) -> List[Dict[str, np.ndarray]]:
    """int64[k, 9, B] device responses -> per-round host dicts, in ONE
    device-to-host copy."""
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
    ) -> None:
        self.cfg = cfg or DeviceConfig()
        # Any object with millisecond_now() and now() will do.
        self.clock = clock or clock_mod.default_clock()
        self.device = torch.device(self.cfg.device)
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
        self._lock = threading.Lock()
        self.table: SlotTable = init_table(self.cfg.num_slots, self.device)
        # The serve kernel's claim words: all INT32_MAX between launches.
        self.claim = (
            new_claim_buffer(self.cfg.num_slots, self.device)
            if self.device.type == "cuda" else None
        )
        self._tiers = resolve_tiers(self.cfg)
        self.checks = 0
        self.over_limit = 0
        self.not_persisted = 0

    def _add_tally(self, tally: Tally) -> None:
        with self._lock:
            self.checks += tally.checks
            self.over_limit += tally.over_limit
            self.not_persisted += tally.not_persisted

    def _launch(self, qs, nows, seq) -> Tuple[torch.Tensor, torch.Tensor]:
        """One serve-kernel dispatch; caller holds `_lock`."""
        qs = torch.as_tensor(qs, dtype=torch.int64).to(self.device)
        nows = torch.as_tensor(nows, dtype=torch.int64).to(self.device)
        seq = torch.as_tensor(seq, dtype=torch.int64).to(self.device)
        self.table, resps, seq = persistent_serve_step(
            self.table, qs.contiguous(), nows.contiguous(), seq,
            ways=self.cfg.ways, claim=self.claim,
        )
        return resps, seq

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
        if packed.rounds:
            with self._lock:
                resps = self._dispatch_rounds_locked(packed.rounds)
            round_host = packed_rounds_to_host(resps)
        out, tally = unmarshal_responses(
            len(reqs), packed.errors, packed.positions, round_host
        )
        self._add_tally(tally)
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
        closure producing the host response dicts.  The responses are this
        launch's own output tensor, so the closure may run while later
        launches go out."""
        with self._lock:
            resps = self._dispatch_rounds_locked(rounds) if rounds else None

        def fetch() -> List[Dict[str, np.ndarray]]:
            if resps is None:
                return []
            host = packed_rounds_to_host(resps)
            if add_tally:
                self._add_tally(tally_from_rounds(rounds, host))
            return host

        return fetch

    def _dispatch_rounds_locked(self, rounds) -> torch.Tensor:
        """Launch the serve kernel once for all `rounds`; caller holds
        `_lock`.  Returns the un-synced int64[k, 9, t] responses."""
        now = self.clock.millisecond_now()
        qs = rounds_to_qs(rounds, self._tiers)
        nows = np.full(len(rounds), now, dtype=np.int64)
        resps, _ = self._launch(qs, nows, 0)
        return resps

    # -- ring / persistent dispatch (same kernel) ------------------------
    def ring_seq_init(self) -> torch.Tensor:
        """A fresh device-resident ring sequence word."""
        return torch.zeros((), dtype=torch.int64, device=self.device)

    def persistent_serve_dispatch(self, qs, nows, seq):
        """Drain `qs` int64[k, 12, B] stacked rounds in ONE kernel dispatch
        under the lock.  Returns the un-synced (responses[k, 9, B],
        seq + k)."""
        with self._lock:
            return self._launch(qs, nows, seq)

    ring_step_dispatch = persistent_serve_dispatch

    # -- state -----------------------------------------------------------
    def snapshot(self) -> Dict[str, np.ndarray]:
        """Copy the whole table to the host, in the snapshot dict format of
        gubernator_tpu's DeviceBackend."""
        with self._lock:
            return table_to_host(self.table)

    def _install_table(self, arrays: Dict[str, np.ndarray]) -> None:
        """Replace the live table from host arrays (snapshot format)."""
        if arrays["key"].shape[0] != self.cfg.num_slots:
            raise ValueError(
                f"snapshot has {arrays['key'].shape[0]} slots, backend "
                f"expects {self.cfg.num_slots}"
            )
        with self._lock:
            self.table = table_from_host(arrays, self.device)

    def occupancy(self) -> int:
        with self._lock:
            return int(self.table.occupancy())
