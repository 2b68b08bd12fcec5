"""The GLOBAL cell's traffic: a Zipfian pool of calls over a fixed key set,
a populate pass, and the sample of replica buckets that the check follows.

Made from the seed, on the run's device where the draws are large (a
torch.Generator per use of the seed, as generator.py makes them):

- the keys: `keys` ids, each with its own algorithm (token:leaky as
  `algo_mix`), limit (uniform over `limits`) and duration (uniform over the
  multiples of `duration_ms.step` from `low` to `high`), fixed for the run;
  key id i is the hash key `<limit_name>_<seed>.<i>`;
- the populate pass: one seeded permutation of the ids,
  `populate_lanes_per_call` distinct keys a call;
- the pool: `pool_calls` calls of `lanes_per_call` checks, each drawn from
  the Zipf distribution of exponent `zipf_theta` over ranks 1..keys
  (P(rank r) proportional to r^-theta, YCSB's zipfian), rank r mapped to a
  key by a seeded permutation, so the hot keys spread over every owner and
  arrival shard.  The window cycles the pool call after call.

Every seed gets the same sizes and counts: only which keys and which values
change.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from benchmark.generator import _free, _host, rng, torch_gen
from benchmark.reference import global_cluster as gc


class ZipfPool:
    def __init__(self, mix: dict, config: dict, seed: int,
                 device: str = "cpu") -> None:
        import torch

        n = self.keys = int(config["keys"])
        self.name = str(mix["limit_name"])
        self.prefix = f"{int(seed)}."
        self.lanes = int(mix["lanes_per_call"])
        self.populate_lanes = int(mix["populate_lanes_per_call"])
        self.pool_calls = int(mix["pool_calls"])
        self.in_flight = int(mix["in_flight"])
        self.t0_ms = int(mix["clock"]["t0_ms"])
        self.ms_per_call = int(mix["clock"]["ms_per_call"])
        self.hits = int(mix["hits"])
        self.check = mix["check"]
        g = torch_gen(seed, 1, device)
        self.key_of_rank = _host(torch.randperm(n, generator=g,
                                                device=device))
        g = torch_gen(seed, 2, device)
        token, leaky = mix["algo_mix"]["token"], mix["algo_mix"]["leaky"]
        self.algo = _host(torch.rand(n, generator=g, device=device,
                                     dtype=torch.float64)
                          < leaky / (token + leaky)).astype(np.int64)
        lo, hi = mix["limits"]
        self.limit = _host(torch.randint(lo, hi + 1, (n,), generator=g,
                                         device=device))
        d = mix["duration_ms"]
        steps = (int(d["high"]) - int(d["low"])) // int(d["step"]) + 1
        self.duration = int(d["low"]) + int(d["step"]) * _host(
            torch.randint(0, steps, (n,), generator=g, device=device))
        g = torch_gen(seed, 3, device)
        self.populate_order = _host(torch.randperm(n, generator=g,
                                                   device=device))
        g = torch_gen(seed, 4, device)
        ranks = torch.arange(1, n + 1, device=device, dtype=torch.float64)
        cdf = torch.cumsum(ranks.pow(-float(mix["zipf_theta"])), 0)
        cdf /= cdf[-1].clone()
        u = torch.rand(self.pool_calls * self.lanes, generator=g,
                       device=device, dtype=torch.float64)
        rank = torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1)
        key_of_rank = torch.from_numpy(self.key_of_rank).to(device)
        self.pool = _host(key_of_rank[rank]).reshape(self.pool_calls,
                                                     self.lanes)
        del ranks, cdf, u, rank, key_of_rank
        _free(device)
        self.populate_calls = -(-n // self.populate_lanes)

    def hash_keys(self) -> List[str]:
        """Every key's hash key (`name` + "_" + unique key), by id."""
        head = f"{self.name}_{self.prefix}"
        return [head + str(i) for i in range(self.keys)]

    def call_ids(self, g: int) -> np.ndarray:
        """The key ids of the checks of global call g: the populate pass,
        then the pool, cycled."""
        if g < self.populate_calls:
            s = g * self.populate_lanes
            return self.populate_order[s:s + self.populate_lanes]
        return self.pool[(g - self.populate_calls) % self.pool_calls]

    def now_ms(self, g: int) -> int:
        return self.t0_ms + g * self.ms_per_call

    def sample_pairs(self, h: np.ndarray, geo: "gc.Geometry",
                     seed: int) -> List[Tuple[int, int]]:
        """The (card, replica bucket) pairs the check follows, sorted:
        the buckets of the `check.hot_keys` hottest keys on their arrival
        cards, then `check.pairs` drawn from the seed among buckets that
        hold a key, `check.overfull_share` of them among buckets that hold
        more keys than ways (so LRU eviction in the replica is followed
        too)."""
        r = rng(seed, 5)
        rb = gc.rep_bucket(h, geo)
        pairs = set()
        for k in self.key_of_rank[:int(self.check["hot_keys"])]:
            pairs.add((int(gc.arrival(h[k], geo.n)), int(rb[k])))
        count = np.bincount(rb, minlength=geo.nb_rep)
        want = int(self.check["pairs"])
        n_over = int(round(want * float(self.check["overfull_share"])))
        for pool, m in ((np.flatnonzero(count > geo.ways), n_over),
                        (np.flatnonzero(count > 0), want - n_over)):
            m = min(m, pool.size)
            for b in r.choice(pool, m, replace=False).tolist():
                pairs.add((int(r.integers(geo.n)), b))
        return sorted(pairs)
