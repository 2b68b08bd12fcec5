"""Headline benchmark: rate-limit decisions/sec on one card at 10M keys.

    python -m gubernator_tpu_torch.cli.bench

The port of the repo-root bench.py.  The same geometry: a 2^24-slot table
(8-way buckets) under a 10M-key workload, mixed token/leaky bucket,
BENCH_BATCH (default 262144) decisions per step, keys drawn by
default_rng(0), 8 staged batches with unique keys within each batch, one
frozen `now`.  The same env knobs: BENCH_BATCH, BENCH_KEYS,
BENCH_FED_BATCH, BENCH_TOTAL_BUDGET_S, BENCH_FED_BUDGET_S.

The decision step on the card is K1, the hand-written serve kernel
(ops/kernels/serve_kernel.py), so every step here is a K1 dispatch: the
populate (every key inserted, k rounds a dispatch), the KERNEL metric (one
round a dispatch on pre-staged device-resident rounds, responses left on
the device, one sync per 16 steps) and the FED metric (each step uploads a
fresh packed [12, BENCH_FED_BATCH] request block from pinned memory and
fetches the packed [9, BENCH_FED_BATCH] response, double-buffered, on a
clone of the table).  One claim buffer and one scratch buffer serve every
launch.

The north-star target (BASELINE.json) is 12.5M decisions/sec per chip;
`vs_baseline` is value / 12.5e6.  Prints ONE JSON line with the keys of the
JAX bench's: metric, value, unit, vs_baseline and the fed_* companions.

Runs on the CUDA card unless GUBER_TPU_PLATFORM=cpu asks for the CPU (where
K1's wrapper takes its plain version).  Without a card the JAX bench prints
a skip line and exits 0; this one prints the same skip line
({"skipped": true, "reason": "device_unavailable: ..."}) and exits 2,
because here no device hides behind a tunnel: a missing card is a failed
run, not a dark link.  For the same reason a line that carries `fed_error`
(the fed phase failed twice) or `fed_partial` (its budget expired mid-run)
is still printed, labeled, but the run exits 1.
"""
from __future__ import annotations

import json
import math
import os
import signal
import sys
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from gubernator_tpu_torch.ops.kernels import serve_kernel
from gubernator_tpu_torch.ops.state import SlotTable, clone_table, init_table
from gubernator_tpu_torch.runtime.place import DevicePlace

NUM_SLOTS = 1 << 24
WAYS = 8
N_STAGED = 8
NOW0 = 1_700_000_000_000
METRIC = "rate_limit_decisions_per_sec_per_chip_10M_keys"
# Request [12, B] + response [9, B] int64 words a round.
BYTES_PER_DECISION = (12 + 9) * 8
# A populate dispatch's request and response blocks stay near this size.
POPULATE_BLOCK_BYTES = 2 << 30
# Keys of a printed line that make the run exit 1.
FAILED_KEYS = frozenset({"error", "fed_error", "fed_partial"})

_T0 = time.perf_counter()


def _phase(msg: str) -> None:
    """Progress to stderr (stdout carries only the single JSON line)."""
    sys.stderr.write("[bench %7.1fs] %s\n" % (time.perf_counter() - _T0, msg))
    sys.stderr.flush()


def metric_line(value: float, **extra) -> dict:
    return {
        "metric": METRIC,
        "value": round(value, 1),
        "unit": "decisions/s",
        "vs_baseline": round(value / 12.5e6, 4),
        **extra,
    }


def bench_device() -> torch.device:
    """The card, unless GUBER_TPU_PLATFORM=cpu asks for the CPU; raises
    when CUDA is asked for and torch sees no card."""
    dev = torch.device(os.environ.get("GUBER_TPU_PLATFORM") or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def batch_from_keys(ks: torch.Tensor) -> torch.Tensor:
    """Expand a [B] key column into the packed int64[12, B] round on its
    device (ops/batch.pack_batch_q's row order): only the 8-byte key
    column ever crosses the host link.  Key 0 is an inactive lane.  The
    algorithm is bit 7 of the key: an arithmetic shift equals the JAX
    bench's unsigned one only because every key lies in [1, 2^63)."""
    B = ks.shape[0]
    q = torch.zeros((12, B), dtype=torch.int64, device=ks.device)
    active = (ks != 0).to(torch.int64)
    q[0] = ks
    q[1] = active                  # hits
    q[2] = 1000                    # limit
    q[3] = 3_600_000               # duration
    q[4] = (ks >> 7) & 1           # algo
    q[5] = 1000                    # burst = limit
    q[10] = active
    return q


def pack_q(ks: np.ndarray, width: int) -> np.ndarray:
    """The fed metric's host-packed round: the same lanes as
    batch_from_keys, zero past len(ks)."""
    q = np.zeros((12, width), dtype=np.int64)
    m = len(ks)
    q[0, :m] = ks
    q[1, :m] = 1
    q[2, :m] = 1000
    q[3, :m] = 3_600_000
    q[4, :m] = (ks.astype(np.uint64) >> np.uint64(7)) & np.uint64(1)
    q[5, :m] = 1000
    q[10, :m] = 1
    return q


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError as e:
        raise SystemExit(f"{name} must be an integer: {e}")


@dataclass
class BenchRun:
    """What one run leaves behind: its JSON line, and the state a caller
    checks it by (the table after the kernel metric, the claim words, the
    key pool, the staged rows of it, and the staged batch of each round the
    table took after the populate, warm-up included, in order)."""

    line: dict
    table: SlotTable
    claim: Optional[torch.Tensor]
    key_pool: np.ndarray
    staged_idx: np.ndarray
    applied: List[int]
    now: int


class _Stepper:
    """K1 dispatches with one claim buffer and one scratch buffer."""

    def __init__(self, dev: torch.device, num_slots: int, max_k: int,
                 batch: int) -> None:
        self.dev = dev
        self.claim = self.scratch = None
        if dev.type == "cuda":
            self.claim = serve_kernel.new_claim_buffer(num_slots, dev)
            words = serve_kernel.scratch_words(dev, max_k, batch)
            self.scratch = torch.empty(max(words, 1), dtype=torch.int32,
                                       device=dev)
        self.seq = torch.zeros((), dtype=torch.int64, device=dev)

    def __call__(self, table, qs, nows):
        table, resps, _ = serve_kernel.persistent_serve_step(
            table, qs, nows, self.seq, WAYS, self.claim, self.scratch)
        return table, resps

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


def run(num_slots: int, device: torch.device,
        progress: Optional[dict] = None) -> BenchRun:
    """The benchmark at `num_slots` slots on `device`; the CLI passes
    2^24.  `progress["value"]` gets the kernel metric once it is measured
    (main's watchdog reports it if the fed phase hangs)."""
    batch = _env_int("BENCH_BATCH", 262_144)
    n_keys = _env_int("BENCH_KEYS", 10_000_000)
    # Misconfiguration dies before the populate, the fed knob included.
    if n_keys < batch:
        raise SystemExit(
            "BENCH_KEYS (%d) must be >= BENCH_BATCH (%d) for unique "
            "per-batch sampling" % (n_keys, batch))
    fed_batch = min(batch, _env_int("BENCH_FED_BATCH", 4096))
    if fed_batch < 1:
        raise SystemExit("BENCH_FED_BATCH must be >= 1 (got %d)" % fed_batch)
    fed_budget_s = max(
        1, math.ceil(float(os.environ.get("BENCH_FED_BUDGET_S", 120))))
    now = NOW0

    rng = np.random.default_rng(0)
    key_pool = rng.integers(1, 1 << 63, size=n_keys, dtype=np.int64)
    _phase("key pool generated")
    # Staged measurement batches: unique keys WITHIN each batch (the
    # unique-key path, not the duplicate cascade), drawn uniformly from
    # the pool; drawn before any timed window.
    staged_idx = np.stack([
        rng.choice(n_keys, size=batch, replace=False)
        for _ in range(N_STAGED)
    ])
    n_chunks = (n_keys + batch - 1) // batch
    per_dispatch = max(1, POPULATE_BLOCK_BYTES // (BYTES_PER_DECISION * batch))
    per_dispatch = min(per_dispatch, n_chunks)

    table = init_table(num_slots, device)
    step = _Stepper(device, num_slots, per_dispatch, batch)
    _phase("table initialized (%d slots)" % num_slots)

    # Populate: every key inserted, so the measured steady state runs
    # against the full live working set (~60% load at the defaults).
    keys_padded = np.zeros(n_chunks * batch, dtype=np.int64)
    keys_padded[:n_keys] = key_pool
    keys2d = torch.from_numpy(keys_padded.reshape(n_chunks, batch)).to(device)
    for lo in range(0, n_chunks, per_dispatch):
        chunk = keys2d[lo:lo + per_dispatch]
        qs = torch.stack([batch_from_keys(ks) for ks in chunk])
        nows = torch.full((qs.shape[0],), now, dtype=torch.int64,
                          device=device)
        table, _ = step(table, qs, nows)
        del qs
    step.sync()
    del keys2d
    _phase("populate done (%d keys, %d chunks, %d a dispatch)"
           % (n_keys, n_chunks, per_dispatch))

    staged = [
        batch_from_keys(torch.from_numpy(key_pool[staged_idx[i]]).to(device))
        .unsqueeze(0).contiguous()
        for i in range(N_STAGED)
    ]
    now1 = torch.full((1,), now, dtype=torch.int64, device=device)
    applied: List[int] = []
    for i in range(2):  # warm the measurement shape
        table, resp = step(table, staged[i], now1)
        applied.append(i)
    step.sync()
    _phase("warmup done")

    iters = 0
    t0 = time.perf_counter()
    deadline = t0 + 2.0
    while time.perf_counter() < deadline:
        table, resp = step(table, staged[iters % N_STAGED], now1)
        applied.append(iters % N_STAGED)
        iters += 1
        if iters % 16 == 0:
            step.sync()
    step.sync()
    elapsed = time.perf_counter() - t0
    value = batch * iters / elapsed
    if progress is not None:
        progress["value"] = value
    _phase("kernel metric done (%d iters, %.2fs)" % (iters, elapsed))

    fed = _fed(table, step, key_pool, staged_idx, fed_batch, fed_budget_s,
               now1)
    return BenchRun(metric_line(value, **fed), table, step.claim, key_pool,
                    staged_idx, applied, now)


def _fed(table, step, key_pool, staged_idx, fed_batch, fed_budget_s,
         now1) -> dict:
    """The FED companion, best-effort: failures and timeouts are reported
    in fed_error (one retry), never raised."""
    dev = step.dev
    place = DevicePlace.resolve(dev, "bench")
    stream = place.stream
    # Packed at fed_batch width, contiguous and pinned on the card: each
    # step's upload is one non-blocking copy of a fresh request block.
    host_qs = []
    for i in range(N_STAGED):
        q = torch.from_numpy(pack_q(key_pool[staged_idx[i][:fed_batch]],
                                    fed_batch)).unsqueeze(0)
        host_qs.append(q.pin_memory() if stream is not None else q)

    def _fed_alarm(signum, frame):  # noqa: ARG001
        raise TimeoutError("fed phase exceeded BENCH_FED_BUDGET_S")

    def run_fed() -> dict:
        """One attempt under its own SIGALRM budget (best-effort: an alarm
        can land late while a CUDA sync blocks in C).  Reports a PARTIAL
        throughput if the budget dies mid-loop with responses fetched;
        raises only when nothing completed."""
        fetched = 0
        t0 = t_last_fetch = None

        def result(elapsed: float, partial: bool) -> dict:
            fed_value = fed_batch * fetched / elapsed
            out = {
                "fed_decisions_per_sec": round(fed_value, 1),
                "fed_vs_baseline": round(fed_value / 12.5e6, 4),
                "fed_batch": fed_batch,
                "fed_link_bytes_per_decision": BYTES_PER_DECISION,
                "fed_implied_link_MBps": round(
                    fed_value * BYTES_PER_DECISION / 1e6, 1),
                "fed_note": (
                    "per-step H2D request upload from pinned memory + D2H "
                    "response fetch (one K1 dispatch at the service-drain "
                    "lane count), double-buffered, on a clone of the "
                    "table; on the card's own host link"
                ),
            }
            if partial:
                out["fed_partial"] = (
                    "fed budget expired mid-run; throughput is over the %d "
                    "responses fetched before expiry, timed to the LAST "
                    "successful fetch" % fetched)
            return out

        old_alarm = signal.signal(signal.SIGALRM, _fed_alarm)
        signal.alarm(fed_budget_s)
        try:
            # K1 updates its table in place: each attempt steps a fresh
            # copy, and the measured table stays as the kernel metric left
            # it.
            table2 = clone_table(table)
            table2, r = step(table2, host_qs[0].to(dev, non_blocking=True),
                             now1)
            place.fetch([r[0]]).wait()  # warm the transfer path
            _phase("fed warmup done")
            pending = None
            fed_iters = 0
            t0 = time.perf_counter()
            deadline = t0 + 2.0
            while time.perf_counter() < deadline or pending is not None:
                nxt = None
                if time.perf_counter() < deadline:
                    q_dev = host_qs[fed_iters % N_STAGED].to(
                        dev, non_blocking=True)
                    table2, r = step(table2, q_dev, now1)
                    nxt = place.fetch([r[0]])
                    fed_iters += 1
                if pending is not None:
                    pending.wait()  # previous step's full response
                    fetched += 1
                    t_last_fetch = time.perf_counter()
                pending = nxt
            fed_elapsed = time.perf_counter() - t0
            _phase("fed metric done (%d iters, %.2fs)"
                   % (fetched, fed_elapsed))
            return result(fed_elapsed, partial=False)
        except Exception as e:  # noqa: BLE001 — fed is best-effort
            if fetched > 0 and t_last_fetch is not None:
                elapsed = max(t_last_fetch - t0, 1e-9)
                _phase("fed metric PARTIAL after %r (%d fetched, %.2fs)"
                       % (e, fetched, elapsed))
                return result(elapsed, partial=True)
            raise
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old_alarm)

    fed: dict = {}
    for attempt in (1, 2):
        try:
            return run_fed()
        except Exception as e:  # noqa: BLE001 — LABELED in the artifact
            _phase("fed attempt %d FAILED: %r" % (attempt, e))
            fed = {"fed_error": "%s: %s" % (type(e).__name__, e)}
            if attempt == 1:
                time.sleep(5)
    return fed


def main() -> int:
    """One JSON line on stdout; exits 0 only when both metrics completed
    (1 on a line with fed_error or fed_partial).  A daemon timer
    (BENCH_TOTAL_BUDGET_S, default 2700 s, floor 60 s) prints a LABELED line
    and exits 3 if the run hangs: the kernel value when that phase
    completed, else an error."""
    progress: dict = {"value": None}
    try:
        budget_s = float(os.environ.get("BENCH_TOTAL_BUDGET_S", 2700))
    except ValueError as e:
        raise SystemExit("BENCH_TOTAL_BUDGET_S must be a number: %s" % e)
    budget_s = max(60.0, budget_s)
    # The watchdog and the normal path race near the budget boundary
    # (Timer.cancel cannot stop a running callback): emission is once-only.
    emit_lock = threading.Lock()
    emitted = [False]

    def emit_once(line: dict) -> bool:
        with emit_lock:
            if emitted[0]:
                return False
            emitted[0] = True
        print(json.dumps(line), flush=True)
        return True

    def total_watchdog() -> None:
        if progress["value"] is not None:
            line = metric_line(progress["value"], fed_error=(
                "total budget exceeded after kernel phase"))
        else:
            line = metric_line(0, error=(
                "device_unreachable: no phase completed within "
                "BENCH_TOTAL_BUDGET_S=%.0fs" % budget_s))
        if emit_once(line):
            _phase("TOTAL BUDGET EXCEEDED — emitted watchdog line, exiting")
            os._exit(3)

    try:
        dev = bench_device()
    except RuntimeError as e:
        emit_once({
            "metric": METRIC,
            "skipped": True,
            "reason": "device_unavailable: %s: %s" % (type(e).__name__, e),
        })
        _phase("SKIPPED — no CUDA card and GUBER_TPU_PLATFORM is not cpu")
        return 2
    watchdog = threading.Timer(budget_s, total_watchdog)
    watchdog.daemon = True
    watchdog.start()
    try:
        line = run(NUM_SLOTS, dev, progress).line
    finally:
        watchdog.cancel()
    emit_once(line)
    return 1 if FAILED_KEYS & set(line) else 0


if __name__ == "__main__":
    sys.exit(main())
