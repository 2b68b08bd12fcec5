"""The one traffic generator: it reads a traffic mix (a data file under
benchmark/traffic/) and makes the cell's inputs from the seed.

The large draws run on the run's device (a torch.Generator seeded from the
seed, a few large calls) and come back to the host as the columns the
engine is handed; the same seed on the same kind of device gives the same
inputs.  Two key orders cover the mixes:

- `"permutation"`: the configuration's `keys` live keys, visited as one
  seeded permutation pass after another.  Each key carries its own
  algorithm, limit, duration and RESET_REMAINING flag, drawn from the
  seed; every call takes the next `lanes_per_call` keys of the pass (the
  last call of a pass the rest).  The keys' buckets also give the sample
  of buckets that the check follows (`check.buckets`, a share of them
  among buckets holding more keys than ways).
- `"uniform"`: a pool of `pool_calls` calls of `lanes_per_call`
  fingerprints drawn uniformly, with replacement, over the configuration's
  `keys` ids, with per-lane limits, cycled call after call.  `"pass"` for
  `pool_calls` takes as many calls as make one draw a key of the space.
  `sample_lanes_per_call` lanes of each pool call are the ones the check
  compares.

Every seed gets the same sizes, counts and arrivals: only which keys and
which values change.  Fingerprints are the splitmix64 finalizer (a
bijection of 64-bit words) of the key id plus a seeded offset, so distinct
ids give distinct nonzero fingerprints.

A mix's `limits` is [low, high], drawn uniformly by key or lane.  Its
`duration_ms` is {"low", "high", "step"}: uniform over the multiples of
`step` from `low` to `high`.
"""
from __future__ import annotations

import numpy as np

GOLDEN = 0x9E3779B97F4A7C15
M1, M2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB
MASK = 2**64 - 1


def _i64(u: int) -> int:
    """A 64-bit word as a signed int64 value."""
    u &= MASK
    return u - 2**64 if u >= 2**63 else u


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent NumPy generator for one use of the seed."""
    return np.random.default_rng([int(seed) % 2**64, stream])


def torch_gen(seed: int, stream: int, device: str):
    """An independent torch.Generator on `device` for one use of the
    seed."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * GOLDEN + stream * M1) & MASK)
    return g


def _fmix_int(x: int) -> int:
    """The splitmix64 finalizer of one word, in Python integers."""
    x &= MASK
    x ^= x >> 30
    x = (x * M1) & MASK
    x ^= x >> 27
    x = (x * M2) & MASK
    return x ^ (x >> 31)


def fingerprints(ids, seed: int):
    """Nonzero int64 fingerprints of an int64 tensor of key ids, on its
    device: distinct ids give distinct fingerprints.  int64 products wrap,
    and shifts are made logical by a mask."""
    def srl(z, n):
        return (z >> n) & ((1 << (64 - n)) - 1)

    off = (int(seed) * GOLDEN) & MASK
    z = ids + _i64(off)
    z = (z ^ srl(z, 30)) * _i64(M1)
    z = (z ^ srl(z, 27)) * _i64(M2)
    z = z ^ srl(z, 31)
    # The one word that mixes to 0 takes the image of 2^63 + off, which
    # no id in [0, 2^63) reaches.
    return z.masked_fill(z == 0, _i64(_fmix_int(2**63 + off)))


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def _free(device: str) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()


class KeyPasses:
    """`"permutation"` traffic: per-key columns in visiting order."""

    def __init__(self, mix: dict, config: dict, seed: int,
                 device: str = "cpu") -> None:
        import torch

        n = int(config["keys"])
        self.keys = n
        self.lanes = int(mix["lanes_per_call"])
        self.populate_lanes = int(mix.get("populate_lanes_per_call",
                                          self.lanes))
        self.in_flight = int(mix["in_flight"])
        self.t0_ms = int(mix["clock"]["t0_ms"])
        self.ms_per_call = int(mix["clock"]["ms_per_call"])
        order = torch.randperm(n, generator=torch_gen(seed, 1, device),
                               device=device)
        self.key_hash = _host(fingerprints(order, seed))
        del order
        g = torch_gen(seed, 2, device)
        token, leaky = mix["algo_mix"]["token"], mix["algo_mix"]["leaky"]
        self.algo = _host(torch.rand(n, generator=g, device=device,
                                     dtype=torch.float64)
                          < leaky / (token + leaky)).astype(np.int32)
        lo, hi = mix["limits"]
        self.limit = _host(torch.randint(lo, hi + 1, (n,), generator=g,
                                         device=device))
        d = mix["duration_ms"]
        steps = (int(d["high"]) - int(d["low"])) // int(d["step"]) + 1
        self.duration = int(d["low"]) + int(d["step"]) * _host(
            torch.randint(0, steps, (n,), generator=g, device=device))
        self.reset = _host(torch.rand(n, generator=g, device=device,
                                      dtype=torch.float64)
                           < float(mix.get("reset_share", 0.0)))
        _free(device)
        self.hits = int(mix["hits"])
        self.check = mix["check"]
        dev = config["device"]
        self.ways = int(dev["ways"])
        self.buckets = int(dev["num_slots"]) // self.ways

    def bucket_of(self, key_hash: np.ndarray) -> np.ndarray:
        return key_hash & np.int64(self.buckets - 1)

    def calls_per_pass(self, lanes: int) -> int:
        return -(-self.keys // lanes)

    def call_span(self, c: int, lanes: int):
        """Key positions [s, e) of call c of a pass of `lanes`-wide calls."""
        s = c * lanes
        return s, min(s + lanes, self.keys)

    def sample_positions(self, seed: int) -> np.ndarray:
        """Sorted positions of the keys whose buckets the check follows:
        `check.buckets` buckets drawn from the seed, `check.overfull_share`
        of them among buckets that hold more keys than `ways` (so LRU
        eviction is followed too)."""
        ways, buckets = self.ways, self.buckets
        b = self.bucket_of(self.key_hash)
        count = np.bincount(b, minlength=buckets)
        r = rng(seed, 3)
        want = int(self.check["buckets"])
        n_over = int(round(want * float(self.check["overfull_share"])))
        over = np.flatnonzero(count > ways)
        pick_over = r.choice(over, min(n_over, over.size), replace=False) \
            if over.size else np.empty(0, dtype=np.int64)
        held = np.flatnonzero(count > 0)
        pick_any = r.choice(held, min(want - pick_over.size, held.size),
                            replace=False)
        chosen = np.zeros(buckets, dtype=bool)
        chosen[pick_over] = True
        chosen[pick_any] = True
        return np.flatnonzero(chosen[b])


class UniformPool:
    """`"uniform"` traffic: a pool of calls of uniformly drawn keys."""

    def __init__(self, mix: dict, config: dict, seed: int,
                 device: str = "cpu") -> None:
        import torch

        keys = int(config["keys"])
        self.lanes = int(mix["lanes_per_call"])
        pool = mix["pool_calls"]
        self.pool_calls = (-(-keys // self.lanes) if pool == "pass"
                           else int(pool))
        self.warm_calls = int(mix["warm_calls"])
        self.in_flight = int(mix["in_flight"])
        self.roll_after = int(mix["roll_after_calls"])
        self.ms_per_call = int(mix["clock"]["ms_per_call"])
        self.t0_base_ms = int(mix["clock"]["t0_ms"])
        shape = (self.pool_calls, self.lanes)
        g = torch_gen(seed, 1, device)
        ids = torch.randint(0, keys, shape, generator=g, device=device)
        self.key_hash = _host(fingerprints(ids, seed))
        del ids
        lo, hi = mix["limits"]
        self.limit = _host(torch.randint(lo, hi + 1, shape, generator=g,
                                         device=device))
        _free(device)
        self.hits = np.full(self.lanes, int(mix["hits"]), dtype=np.int64)
        k = int(mix["sample_lanes_per_call"])
        r = rng(seed, 3)
        self.sample = np.sort(np.stack([
            r.choice(self.lanes, k, replace=False)
            for _ in range(self.pool_calls)]), axis=1)


def over_by_tenth(call: np.ndarray, status: np.ndarray, calls: int) -> str:
    """The share of answers over their limit in each tenth of a window of
    `calls` calls (`call` < 0: before the window), for the run's log."""
    inside = (call >= 0) & (call < calls)
    tenth = call[inside] * 10 // max(calls, 1)
    over = np.bincount(tenth, weights=status[inside], minlength=10)
    n = np.bincount(tenth, minlength=10)
    return " ".join(f"{100 * o / max(c, 1):.1f}" for o, c in zip(over, n))


ORDERS = {"permutation": KeyPasses, "uniform": UniformPool}


def generate(mix: dict, config: dict, seed: int, device: str = "cpu"):
    """The cell's inputs for traffic mix `mix` on configuration `config`,
    drawn on `device`."""
    return ORDERS[mix["order"]](mix, config, seed, device)
