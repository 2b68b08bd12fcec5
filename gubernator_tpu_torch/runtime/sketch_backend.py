"""Approximate-tier backend: serves selected limit names from the CMS.

The counterpart of gubernator_tpu's runtime/sketch_backend.py.  Limits whose
`name` is in `SketchTierConfig.names` (e.g. per-IP abuse limits with
unbounded cardinality) are answered from the sliding-window count-min sketch
(ops/sketch.py) instead of exact slots.  Memory is O(depth*width) whatever
the key count (the 100M-key tier), at the cost of bounded over-limiting of
hot-colliding keys (never under-limiting).

Dispatch discipline: a whole merge, any size, is padded to a power-of-two
number of `batch_size` chunks and applied with ONE launch of K2, the
hand-written merge kernel (ops/kernels/cms_kernel.py), issued under the lock;
the responses are copied into pinned host memory behind a CUDA event, and the
fetch closure waits on that event only, so concurrent merges pipeline
against each other's device round trips.  `window_start` is mirrored on the
host with the same rotation arithmetic the kernel applies, so building
`reset_time` costs no device read-back.

The device is `device` ("cuda" when None).  Without a CUDA device the
constructor raises unless the caller asked for "cpu", where the kernel's
plain version serves.  Every launch, copy and event goes on `stream` (the
exact tier's stream when a service builds both tiers; else the stream
current at construction): the backend's `place` (runtime/place.py
`DevicePlace`), which uploads from pinned memory and fetches behind its
own event.

Semantics differences from the exact tier, by design:
- `remaining` is an estimate (limit - estimated_count, floored at 0);
- duration selects the sliding window only at tier-config granularity
  (`window_ms`), not per request — callers pick the tier per limit name;
- hits are always counted, even over limit (abusers stay measured).
"""
from __future__ import annotations

import itertools
import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.core import clock as clock_mod
from gubernator_tpu_torch.core.config import SketchTierConfig
from gubernator_tpu_torch.core.hashing import bulk_key_hash64
from gubernator_tpu_torch.core.types import RateLimitReq, RateLimitResp, Status
from gubernator_tpu_torch.ops.kernels import cms_kernel
from gubernator_tpu_torch.ops.sketch import init_sketch
from gubernator_tpu_torch.runtime.place import DevicePlace
from gubernator_tpu_torch.runtime.tracing import stage_begin, stage_end


class HostCMS:
    """The CMS tier's estimator (ops/sketch.py) re-expressed in numpy
    for HOST-side frequency tracking — the hot-key detector's sketch
    (runtime/hotkey.py).

    Same contract as the device tier: per-row multiply-shift universal
    hashing over the int64 key fingerprints, min over `depth` rows,
    never underestimates.  Window semantics are the caller's: the
    tracker tumbles windows with the same boundary arithmetic the
    device kernel's rotation uses (`SketchBackend._advance_window`) and calls
    `clear()` at each boundary.  Memory is O(depth x width) regardless
    of key cardinality, so a zipfian storm cannot grow host state."""

    # Fixed odd multipliers (splitmix64-style constants) — one per row,
    # so the rows are independent hash functions of the SAME
    # fingerprint the device table and the ring router already use.
    _MULTS = (
        0x9E3779B97F4A7C15,
        0xBF58476D1CE4E5B9,
        0x94D049BB133111EB,
        0xD6E8FEB86659FD93,
        0xA0761D6478BD642F,
        0xE7037ED1A0B428DB,
    )

    def __init__(self, depth: int = 4, width: int = 4096) -> None:
        if width & (width - 1) or width <= 0:
            raise ValueError(f"HostCMS width must be a power of two, "
                             f"got {width}")
        if not 1 <= depth <= len(self._MULTS):
            raise ValueError(
                f"HostCMS depth must be 1..{len(self._MULTS)}, "
                f"got {depth}"
            )
        self.depth = depth
        self.width = width
        self._shift = np.uint64(64 - int(width).bit_length() + 1)
        self._mults = [np.uint64(m) for m in self._MULTS[:depth]]
        self.table = np.zeros((depth, width), dtype=np.int64)

    def _row_idx(self, u: np.ndarray, d: int) -> np.ndarray:
        # Multiply-shift: top log2(width) bits of (u * odd_const).
        with np.errstate(over="ignore"):
            return ((u * self._mults[d]) >> self._shift).astype(np.int64)

    def update(self, key_hashes: np.ndarray, weights: np.ndarray) -> None:
        """Add `weights[i]` to fingerprint `key_hashes[i]` (vectorized;
        duplicate fingerprints in one call accumulate)."""
        u = key_hashes.view(np.uint64)
        w = weights.astype(np.int64, copy=False)
        for d in range(self.depth):
            np.add.at(self.table[d], self._row_idx(u, d), w)

    def estimate(self, key_hashes: np.ndarray) -> np.ndarray:
        """Min-over-rows point estimates; >= the true count, always."""
        u = key_hashes.view(np.uint64)
        est = self.table[0][self._row_idx(u, 0)]
        for d in range(1, self.depth):
            est = np.minimum(est, self.table[d][self._row_idx(u, d)])
        return est

    def estimate_one(self, key_hash: int) -> int:
        return int(self.estimate(np.array([key_hash], dtype=np.int64))[0])

    def clear(self) -> None:
        self.table[:] = 0


class SketchBackend:
    """CMS limiter over fixed-shape device batches."""

    def __init__(
        self,
        cfg: SketchTierConfig,
        clock: Optional[clock_mod.Clock] = None,
        device=None,
        stream=None,
    ) -> None:
        self.cfg = cfg
        self.clock = clock or clock_mod.default_clock()
        self.place = DevicePlace.resolve(device, type(self).__name__, stream)
        self.device = self.place.device
        self.state = init_sketch(
            depth=cfg.depth, width=cfg.width, window_ms=cfg.window_ms,
            device=self.device,
        )
        self._lock = threading.Lock()
        # Numbers each merge: the `call` of its stages (runtime/tracing.py);
        # `_call` is the dispatching merge's (`_lock` held).
        self._calls = itertools.count(1)
        self._call = 0
        self.batch = cfg.batch_size
        # Dynamic spillover state (cfg.spill_inserts/spill_transients):
        # names the exact tier degraded here at runtime, plus the
        # per-name-hash pressure state feeding the policy.  Guarded by
        # _spill_lock — the fast-lane pool reports pressure from its
        # worker threads while the service path reads membership.
        # Pressure per name is (hll_registers uint8[64], transients):
        # cardinality comes from a HyperLogLog over the insert lanes'
        # 64-bit key fingerprints, NOT a raw insert count — a long-lived
        # healthy name whose keys expire and re-insert must never look
        # like a cardinality bomb (the estimate converges on DISTINCT
        # keys; ~±13% at 64 registers, plenty for an order-of-magnitude
        # threshold).
        self._spill_lock = threading.Lock()
        self._dyn_names: set = set()
        self._dyn_hashes: np.ndarray = np.empty(0, dtype=np.int64)
        self._pressure: Dict[int, list] = {}  # h -> [hll_regs, transients]
        self.spillovers = 0  # metric mirror (sketch_spillover_total)
        # Optional hook fired once per actual spill (a service wires its
        # counter here so operator-initiated spill_name calls count too).
        self.on_spill = None
        # Bumped per spill so routing caches rebuild their combined hash
        # array only on membership change.
        self.membership_version = 0
        # Host mirror of state.window_start (ms), advanced with the same
        # arithmetic as the kernel's rotation — reset_time needs no device
        # read-back.
        self._win_start = 0

    def handles(self, req: RateLimitReq) -> bool:
        return req.name in self.cfg.names or req.name in self._dyn_names

    @property
    def spill_enabled(self) -> bool:
        return (
            self.cfg.spill_inserts is not None
            or self.cfg.spill_transients is not None
        )

    def dynamic_hashes(self) -> np.ndarray:
        """XXH64 name fingerprints of runtime-spilled names (appended to
        the configured set by the fast lane's routing)."""
        return self._dyn_hashes

    def spill_name(self, name: str) -> bool:
        """Route `name` to the sketch tier from now on (runtime degrade;
        operators may call this directly).  Existing exact rows for the
        name are orphaned and expire naturally — answers for the name
        become approximate (metadata tier=sketch), never lost.  Returns
        False when the name was already sketch-tier (no-op)."""
        with self._spill_lock:
            if name in self._dyn_names or name in self.cfg.names:
                return False
            self._dyn_names.add(name)
            self._dyn_hashes = np.concatenate(
                [self._dyn_hashes, bulk_key_hash64([name])]
            )
            self.spillovers += 1
            self.membership_version += 1
            hook = self.on_spill
        logging.getLogger("gubernator_tpu_torch.sketch").warning(
            "exact-tier pressure: limit name %r degraded to the "
            "count-min-sketch tier (approximate answers)", name,
        )
        if hook is not None:
            hook()
        return True

    # Pressure-map size bound: one entry (64-byte HLL + a counter) per
    # distinct limit NAME hash.  A name sweep must not grow host memory
    # without bound, so past the cap the entries furthest from any
    # threshold are dropped — they re-accumulate if the pressure was
    # real.
    _PRESSURE_CAP = 16_384
    _HLL_M = 64  # registers; standard error ~1.04/sqrt(m) ≈ 13%

    @staticmethod
    def _hll_estimate(regs: np.ndarray) -> float:
        m = len(regs)
        est = (0.709 * m * m) / float(
            np.sum(np.exp2(-regs.astype(np.float64)))
        )
        if est <= 2.5 * m:
            zeros = int((regs == 0).sum())
            if zeros:
                est = m * np.log(m / zeros)  # small-range correction
        return est

    def note_exact_pressure_batch(self, items, decode_names) -> int:
        """Accumulate one drain's exact-tier pressure and spill names
        whose thresholds cross.  `items` is a list of
        (name_hash, insert_key_hashes int64[], transients_count);
        `decode_names(name_hash)` lazily yields the name string (only
        called for crossing names).  One lock hold covers the whole
        drain.  Returns the number of names actually spilled (dedup
        inside spill_name)."""
        ins_thr = self.cfg.spill_inserts
        tra_thr = self.cfg.spill_transients
        m = self._HLL_M
        crossed: List[int] = []
        with self._spill_lock:
            for name_hash, ins_keys, transients in items:
                p = self._pressure.get(name_hash)
                if p is None:
                    p = [np.zeros(m, dtype=np.uint8), 0]
                    self._pressure[name_hash] = p
                if len(ins_keys):
                    # HLL update: register = LOW 6 bits of the key
                    # fingerprint (robust to any bias in the high bits),
                    # rank = leading-zeros+1 of the remaining 58 bits.
                    u = ins_keys.view(np.uint64)
                    reg = (u & np.uint64(m - 1)).astype(np.int64)
                    bits = (u >> np.uint64(6)) << np.uint64(6)
                    rank = np.ones(len(u), dtype=np.uint8)
                    for shift in (32, 16, 8, 4, 2, 1):
                        hi = bits >> np.uint64(64 - shift)
                        z = hi == 0
                        rank = np.where(
                            z, rank + np.uint8(shift), rank
                        ).astype(np.uint8)
                        bits = np.where(z, bits << np.uint64(shift), bits)
                    np.maximum.at(p[0], reg, rank)
                p[1] += int(transients)
                over = (
                    ins_thr is not None
                    and self._hll_estimate(p[0]) >= ins_thr
                ) or (tra_thr is not None and p[1] >= tra_thr)
                if over:
                    # The name leaves the exact tier — state done.
                    self._pressure.pop(name_hash, None)
                    crossed.append(name_hash)
            if len(self._pressure) > self._PRESSURE_CAP:
                # Rank by normalized distance to the NEAREST threshold
                # (a raw register-vs-count comparison would let junk
                # transients evict a near-threshold cardinality bomb's
                # HLL state under a concurrent name sweep).
                def closeness(p) -> float:
                    c = 0.0
                    if ins_thr is not None:
                        c = max(c, self._hll_estimate(p[0]) / ins_thr)
                    if tra_thr is not None:
                        c = max(c, p[1] / tra_thr)
                    return c

                keep = sorted(
                    self._pressure.items(),
                    key=lambda kv: closeness(kv[1]),
                    reverse=True,
                )[: self._PRESSURE_CAP // 2]
                self._pressure = dict(keep)
        spilled = 0
        for nh in crossed:
            if self.spill_name(decode_names(nh)):
                spilled += 1
        return spilled

    def warmup(self) -> None:
        """Build K2's library (nvcc, at first use) and launch it once on a
        throwaway sketch, so that no serving call pays for the compile or
        the module load.  On the CPU there is nothing to build."""
        if self.place.stream is None:
            return
        cms_kernel.library()
        with self.place.on_stream():
            z64 = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
            z32 = torch.zeros((1, 1), dtype=torch.int32, device=self.device)
            cms_kernel.cms_multi_step(
                init_sketch(self.cfg.depth, 1, self.cfg.window_ms,
                            self.device),
                z64, z32, z32, 0)
        self.place.synchronize()

    def _advance_window(self, now_ms: int) -> None:
        """The kernel's rotation arithmetic on the host mirror (called
        under the lock, with the same `now` the dispatch uses).  Python's
        `%` is the floor-mod the kernel computes."""
        w = self.cfg.window_ms
        elapsed = now_ms - self._win_start
        if elapsed >= w:
            self._win_start = now_ms - (elapsed % w)

    def _dispatch(self, kh: np.ndarray, hc: np.ndarray, lc: np.ndarray,
                  now: int) -> torch.Tensor:
        """Roll the host mirror of the window to `now` and launch K2 once
        for a padded merge (the plain step on the CPU); caller holds
        `_lock` and is on the backend's stream.  Returns the un-synced
        int32[k, 2, B]."""
        call = self._call
        t = stage_begin()
        kh, hc, lc = [self.place.upload(a) for a in (kh, hc, lc)]
        stage_end("sketch.stage", call, t)
        t = stage_begin()
        self._advance_window(now)
        self.state, packed = cms_kernel.cms_multi_step(
            self.state, kh, hc, lc, now)
        stage_end("sketch.launch", call, t)
        return packed

    def check_cols(
        self,
        key_hash: np.ndarray,
        hits: np.ndarray,
        limits: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Columnar check (the fast lane and check()'s core): int64
        fingerprint / hits / limit arrays in, (status, remaining,
        reset_time) int64 arrays out.  Validation happens upstream (the
        wire parser's err column / check()'s request validation)."""
        return self.check_cols_begin(key_hash, hits, limits)()

    def check_cols_begin(
        self,
        key_hash: np.ndarray,
        hits: np.ndarray,
        limits: np.ndarray,
    ):
        """Dispatch stage of check_cols: clamp/pad/chunk and issue the
        ONE launch under the lock, then return a zero-arg fetch closure
        producing (status, remaining, reset_time).  The closure waits for
        this merge's own output only, so the pipelined fast lane runs it
        on its fetch stage while the next merge dispatches."""
        n = len(key_hash)
        call = next(self._calls)
        t = stage_begin()
        # Sketch cells are int32; clamp limits/hits into range ONCE so
        # the device decision and the host-side `remaining` agree (an
        # unclamped int64 limit would wrap in the int32 cast below and
        # flip the decision while `remaining` reported billions left).
        # A window limit beyond 2^31-1 is outside the tier's design
        # envelope anyway — the clamp only changes such configs.
        i32max = np.int64(2**31 - 1)
        limits = np.clip(limits, -i32max, i32max)
        hits = np.clip(hits, -i32max, i32max)
        B = self.batch
        k = 1
        while k * B < n:
            k <<= 1
        pad = k * B - n
        kh = np.concatenate(
            [key_hash, np.zeros(pad, dtype=np.int64)]
        ).reshape(k, B)
        hc = np.concatenate(
            [hits, np.zeros(pad, dtype=np.int64)]
        ).astype(np.int32).reshape(k, B)
        lc = np.concatenate(
            [limits, np.zeros(pad, dtype=np.int64)]
        ).astype(np.int32).reshape(k, B)
        stage_end("sketch.prep", call, t)
        with self._lock, self.place.on_stream():
            now = int(self.clock.millisecond_now())
            self._call = call
            packed = self._dispatch(kh, hc, lc, now)
            reset_val = self._win_start + self.cfg.window_ms
            t = stage_begin()
            # This merge's own responses, copied behind its own event.
            pending = self.place.fetch([packed])
            stage_end("sketch.stage", call, t)

        def fetch() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
            t = stage_begin()
            pending.synchronize()
            stage_end("sketch.wait", call, t)
            t = stage_begin()
            (out,) = pending.wait()
            over = out[:, 0, :].reshape(-1)[:n]
            est = out[:, 1, :].reshape(-1)[:n].astype(np.int64)
            status = over.astype(np.int64)
            remaining = np.maximum(0, limits - est - np.maximum(hits, 0))
            reset = np.full(n, reset_val, dtype=np.int64)
            stage_end("sketch.answer", call, t)
            return status, remaining, reset

        return fetch

    def check(self, reqs: Sequence[RateLimitReq]) -> List[RateLimitResp]:
        # Same validation contract as the exact packer
        # (gubernator.go:228-237): errored requests get an error response
        # and never touch the sketch (an empty unique_key would otherwise
        # collide every such client on one shared bucket).
        errors: dict = {}
        valid: List[RateLimitReq] = []
        for i, r in enumerate(reqs):
            if not r.unique_key:
                errors[i] = "field 'unique_key' cannot be empty"
            elif not r.name:
                errors[i] = "field 'namespace' cannot be empty"
            else:
                valid.append(r)
        if errors:
            inner = self.check(valid) if valid else []
            out_all: List[RateLimitResp] = []
            it = iter(inner)
            for i in range(len(reqs)):
                if i in errors:
                    out_all.append(RateLimitResp(error=errors[i]))
                else:
                    out_all.append(next(it))
            return out_all

        n = len(reqs)
        if n == 0:
            return []
        kh = bulk_key_hash64([r.hash_key() for r in reqs])
        hits = np.array([r.hits for r in reqs], dtype=np.int64)
        limits = np.array([r.limit for r in reqs], dtype=np.int64)
        status, remaining, reset = self.check_cols(kh, hits, limits)
        return [
            RateLimitResp(
                status=(
                    Status.OVER_LIMIT if status[j]
                    else Status.UNDER_LIMIT
                ),
                limit=int(limits[j]),
                remaining=int(remaining[j]),
                reset_time=int(reset[j]),
                metadata={"tier": "sketch"},
            )
            for j in range(n)
        ]
