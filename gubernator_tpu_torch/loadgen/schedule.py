"""Deterministic open-loop arrival schedules (docs/loadgen.md).

A schedule is the *plan* of a load phase, precomputed before the first
RPC leaves: every arrival's intended-send timestamp plus the key it
will hit.  The open-loop engine (engine.py) dispatches against these
intended times and records latency FROM them, so a stalled server
cannot delay the next arrival or flatter the tail (coordinated
omission — the closed-loop failure mode where a 200ms stall hides all
but one of its victims from the p99).

Determinism contract (pinned by golden digest in tests/test_loadgen.py):

  * Every draw flows from ``numpy.random.default_rng(seed)`` where the
    seed is derived by ``derive_seed`` from the scenario seed and a
    stable string path (the sha512 idiom testing/chaos.py uses —
    process-salted ``hash()`` would break cross-process replay).
  * Worker sharding is by arrival-index stride, so the union of any
    worker count's shards is the one full schedule and merged HDR
    state is identical for 1, 2, or N workers (merge is commutative).

Besides the JAX package's kinds, the port has one draw-free arrival
process and key draw, for runs that must hit every key an exact number
of times: ``paced`` (exactly round(rps x duration) arrivals in groups of
``params["group"]`` that share one intended-send time, the groups evenly
spaced) and ``cycle`` (arrival i hits key i mod universe).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List

import numpy as np


def derive_seed(seed: int, path: str) -> int:
    """A stable sub-seed for `path` (e.g. "flashcrowd/1/keys") — the
    same derivation in every process, unlike salted hash()."""
    digest = hashlib.sha512(f"{seed}/{path}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


@dataclass(frozen=True)
class Schedule:
    """One phase's precomputed arrival plan.

    ``times_s`` are intended-send offsets from phase start (sorted,
    float64 seconds); ``key_idx[i]`` is the key-universe index arrival
    ``i`` hits.  Key *names* are materialized by the scenario (spec.py)
    so the same plan can drive different tenants.
    """

    times_s: np.ndarray
    key_idx: np.ndarray

    def __post_init__(self) -> None:
        if len(self.times_s) != len(self.key_idx):
            raise ValueError(
                f"schedule arrays disagree: {len(self.times_s)} times "
                f"vs {len(self.key_idx)} keys"
            )

    def __len__(self) -> int:
        return len(self.times_s)

    def digest(self) -> str:
        """Content digest over ns-quantized times + key draws — the
        schedule-determinism pin (identical seed => identical hex)."""
        h = hashlib.sha256()
        h.update(np.round(self.times_s * 1e9).astype(np.int64).tobytes())
        h.update(self.key_idx.astype(np.int64).tobytes())
        return h.hexdigest()

    def shard(self, workers: int) -> List["Schedule"]:
        """Stride-partition among `workers`: arrival i -> worker
        i % workers.  The shards' union is exactly this schedule, so
        per-worker recorders merge to the same state regardless of
        worker count or merge order."""
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        return [
            Schedule(self.times_s[w::workers], self.key_idx[w::workers])
            for w in range(workers)
        ]


# -- arrival processes (intended-send offsets) -------------------------


def poisson_times(seed: int, rps: float, duration_s: float) -> np.ndarray:
    """Steady Poisson arrivals: i.i.d. exponential inter-arrival gaps
    at `rps`, truncated to `duration_s`."""
    if rps <= 0 or duration_s <= 0:
        raise ValueError(
            f"rps and duration must be > 0, got {rps}, {duration_s}"
        )
    rng = np.random.default_rng(seed)
    # Over-draw, then truncate: 5 sigma headroom over the expectation.
    n = int(rps * duration_s + 5 * max(1.0, (rps * duration_s) ** 0.5)) + 8
    t = np.cumsum(rng.exponential(1.0 / rps, size=n))
    return t[t < duration_s]


def paced_times(rps: float, duration_s: float, group: int = 1
                ) -> np.ndarray:
    """Exactly round(rps x duration_s) arrivals, `group` at a time at
    one intended-send offset, a group every group / rps seconds."""
    if rps <= 0 or duration_s <= 0 or group < 1:
        raise ValueError(
            f"rps and duration must be > 0 and group >= 1, got {rps}, "
            f"{duration_s}, {group}"
        )
    n = int(round(rps * duration_s))
    return (np.arange(n, dtype=np.int64) // group) * (group / rps)


def _thinned_times(
    seed: int, peak_rps: float, duration_s: float, rate_fn
) -> np.ndarray:
    """Inhomogeneous Poisson by thinning: candidates at `peak_rps`,
    kept with probability rate(t)/peak (Lewis & Shedler)."""
    cand = poisson_times(seed, peak_rps, duration_s)
    rng = np.random.default_rng(derive_seed(seed, "thin"))
    keep = rng.random(len(cand)) < (rate_fn(cand) / peak_rps)
    return cand[keep]


def diurnal_times(
    seed: int, base_rps: float, peak_rps: float,
    period_s: float, duration_s: float,
) -> np.ndarray:
    """A diurnal wave compressed to `period_s`: sinusoidal rate from
    `base_rps` (trough) to `peak_rps` (crest)."""
    if peak_rps < base_rps:
        raise ValueError(f"peak {peak_rps} < base {base_rps}")
    mid = (base_rps + peak_rps) / 2.0
    amp = (peak_rps - base_rps) / 2.0

    def rate(t):
        return mid + amp * np.sin(2 * np.pi * t / period_s)

    return _thinned_times(seed, peak_rps, duration_s, rate)


def burst_times(
    seed: int, base_rps: float, burst_rps: float,
    burst_every_s: float, burst_len_s: float, duration_s: float,
) -> np.ndarray:
    """Burst storm: `base_rps` background with `burst_rps` square-wave
    bursts of `burst_len_s` every `burst_every_s`."""
    if burst_rps < base_rps:
        raise ValueError(f"burst {burst_rps} < base {base_rps}")

    def rate(t):
        in_burst = np.mod(t, burst_every_s) < burst_len_s
        return np.where(in_burst, burst_rps, base_rps)

    return _thinned_times(seed, burst_rps, duration_s, rate)


# -- key draws ---------------------------------------------------------


def cycle_keys(n: int, universe: int) -> np.ndarray:
    """Arrival i hits key i mod universe: each key n // universe or
    n // universe + 1 times, a group of arrivals on distinct keys."""
    return np.arange(n, dtype=np.int64) % universe


def uniform_keys(seed: int, n: int, universe: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, universe, size=n, dtype=np.int64)


def zipf_keys(seed: int, s: float, n: int, universe: int) -> np.ndarray:
    """Seeded zipfian ranks in [0, universe) — the flash-crowd head.
    Same truncated-zipf construction as testing/chaos.zipf_keys, kept
    here so the load plane has no dependency on the test package."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, universe + 1, dtype=np.float64)
    p = ranks ** (-s)
    p /= p.sum()
    return rng.choice(universe, size=n, p=p).astype(np.int64)


_ARRIVALS = {
    "steady": lambda seed, rps, dur, p: poisson_times(seed, rps, dur),
    "diurnal": lambda seed, rps, dur, p: diurnal_times(
        seed, p.get("base_fraction", 0.2) * rps, rps,
        p.get("period_s", dur), dur,
    ),
    "burst": lambda seed, rps, dur, p: burst_times(
        seed, p.get("base_fraction", 0.2) * rps, rps,
        p.get("burst_every_s", dur / 2.0),
        p.get("burst_len_s", dur / 4.0), dur,
    ),
    "paced": lambda seed, rps, dur, p: paced_times(
        rps, dur, p.get("group", 1)
    ),
}

_KEYS = {
    "uniform": lambda seed, n, universe, p: uniform_keys(
        seed, n, universe
    ),
    "zipf": lambda seed, n, universe, p: zipf_keys(
        seed, p.get("s", 1.3), n, universe
    ),
    "cycle": lambda seed, n, universe, p: cycle_keys(n, universe),
}


def build(
    kind: str, keys: str, seed: int, target_rps: float,
    duration_s: float, universe: int, params: dict = None,
) -> Schedule:
    """One phase's schedule: `kind` arrival process (steady / diurnal /
    burst / paced) at `target_rps` peak over `duration_s`, hitting
    `keys`-drawn (uniform / zipf / cycle) indexes in [0, universe)."""
    p = params or {}
    try:
        arrivals = _ARRIVALS[kind]
    except KeyError:
        raise ValueError(
            f"unknown arrival kind {kind!r} "
            f"(one of {sorted(_ARRIVALS)})"
        ) from None
    try:
        draw = _KEYS[keys]
    except KeyError:
        raise ValueError(
            f"unknown key distribution {keys!r} (one of {sorted(_KEYS)})"
        ) from None
    t = arrivals(derive_seed(seed, f"{kind}/times"), target_rps,
                 duration_s, p)
    k = draw(derive_seed(seed, f"{keys}/keys"), len(t), universe, p)
    return Schedule(times_s=t, key_idx=k)
