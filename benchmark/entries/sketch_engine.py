"""Entry module of the sketch tier: `SketchBackend.check_cols_begin` and the
fetch closure it returns, called as the fast lane's sketch merge calls
them (runtime/fastpath.py `_sketch_process`): int64 fingerprint, hits and
limit columns of one merge a call.

Set-up makes the pool of calls from the seed, runs the program's own
`warmup()` (K2's load and one launch on a throwaway sketch), and warms the
sketch with `warm_calls` calls of the pool through the same entry.  The
clock is virtual (call g at t0 + g * ms_per_call), and t0 is set so that
the sliding window rolls `roll_after_calls` calls into the measured
window.  The check compares the sampled lanes' answers of every call, and
the whole sketch once the window has closed, against the plain reference
(reference/cms.py).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from benchmark.generator import generate, over_by_tenth
from benchmark.reference.cms import CmsReference
from benchmark.yardstick import sketch_useful_bytes


class Entry:
    kind = "sketch"

    def __init__(self, config: dict, mix: dict, seed: int, device: str,
                 log) -> None:
        self.config, self.mix, self.seed = config, mix, seed
        self.device, self.log = device, log
        self.traced = False
        self.traced_calls: List[int] = []
        self.window_calls = 0
        self._rec: List[tuple] = []
        self._state: Optional[Dict[str, np.ndarray]] = None

    def make_traffic(self) -> None:
        t = self.t = generate(self.mix, self.config, self.seed,
                              self.device)
        self.in_flight = t.in_flight
        s = self.config["sketch"]
        self.depth, self.width = int(s["depth"]), int(s["width"])
        self.window_ms, self.chunk = int(s["window_ms"]), int(s["batch_size"])
        roll = t.warm_calls + t.roll_after
        base = t.t0_base_ms // self.window_ms * self.window_ms
        self.t0 = base - roll * t.ms_per_call

    def setup(self) -> None:
        from gubernator_tpu_torch.core.clock import Clock
        from gubernator_tpu_torch.core.config import SketchTierConfig
        from gubernator_tpu_torch.runtime.sketch_backend import SketchBackend

        t0 = time.perf_counter()
        self.make_traffic()
        t1 = time.perf_counter()
        cfg = SketchTierConfig(
            names=list(self.config["sketch"]["names"]), depth=self.depth,
            width=self.width, window_ms=self.window_ms,
            batch_size=self.chunk)
        self.clock = Clock()
        self.clock.freeze(self.t0 * 10**6)
        self.be = SketchBackend(cfg, clock=self.clock, device=self.device)
        self.be.warmup()
        pending = []
        for g in range(self.t.warm_calls):
            pending.append(self._begin(g))
            if len(pending) == self.in_flight:
                self._end(pending.pop(0))
        while pending:
            self._end(pending.pop(0))
        self.log(f"set-up: traffic {t1 - t0:.3f} s, engine, warmup() and "
                 f"{self.t.warm_calls} warm calls "
                 f"{time.perf_counter() - t1:.3f} s")

    def _begin(self, g: int):
        t = self.t
        self.clock.freeze((self.t0 + g * t.ms_per_call) * 10**6)
        p = g % t.pool_calls
        return g, p, self.be.check_cols_begin(t.key_hash[p], t.hits,
                                              t.limit[p])

    def _end(self, token) -> int:
        g, p, fetch = token
        status, remaining, reset = fetch()
        idx = self.t.sample[p]
        self._rec.append((g, np.stack(
            [status[idx], remaining[idx], reset[idx]], axis=1)))
        if self.traced:
            self.traced_calls.append(g)
        return len(status)

    def dispatch(self, i: int):
        self.window_calls = max(self.window_calls, i + 1)
        return self._begin(self.t.warm_calls + i)

    def fetch(self, token) -> int:
        return self._end(token)

    @property
    def traced_bytes(self) -> int:
        """Useful bytes of the calls fetched while traced."""
        t, total, seen = self.t, 0, {}
        roll = t.warm_calls + t.roll_after
        for g in self.traced_calls:
            key = (g % t.pool_calls, g == roll)
            if key not in seen:
                kh = t.key_hash[key[0]]
                k = -(-kh.size // self.chunk)
                k = 1 << (k - 1).bit_length()
                padded = np.zeros(k * self.chunk, dtype=np.int64)
                padded[:kh.size] = kh
                seen[key] = sketch_useful_bytes(
                    self.depth, self.width, padded.reshape(k, self.chunk),
                    rolled=key[1])
            total += seen[key]
        return total

    # -- the check -------------------------------------------------------
    def read_state(self) -> None:
        st = self.be.state
        self._state = {"cur": st.cur.cpu().numpy(),
                       "prev": st.prev.cpu().numpy(),
                       "window_start": np.int64(int(st.window_start))}

    def free(self) -> None:
        import torch

        self.be = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self) -> CmsReference:
        t = self.t
        return CmsReference(t.key_hash, t.hits[None, :], t.limit,
                            self.depth, self.width, self.chunk,
                            self.window_ms, self.t0, t.ms_per_call,
                            device=self.device)

    def _sampled(self, calls: int):
        t = self.t
        base = np.arange(calls, dtype=np.int64)
        lane = t.sample[base % t.pool_calls].reshape(-1)
        return np.repeat(base, t.sample.shape[1]), lane

    def verify(self) -> Dict[str, tuple]:
        """The compared numbers, each with its limit: sampled answers and
        sketch cells that differ from the reference's."""
        calls = self.t.warm_calls + self.window_calls
        ref = self.reference()
        g, lane = self._sampled(calls)
        want = np.stack(ref.answers(g, lane), axis=1)
        got = np.concatenate([a for _, a in sorted(
            self._rec, key=lambda r: r[0])])
        if got.shape != want.shape:
            wrong = max(len(got), len(want))
        else:
            wrong = int(np.count_nonzero((got != want).any(axis=1)))
        tables = ref.tables(calls)
        cells = int(np.count_nonzero(self._state["cur"] != tables["cur"])
                    + np.count_nonzero(self._state["prev"]
                                       != tables["prev"])
                    + int(self._state["window_start"]
                          != tables["window_start"]))
        rolled = int(ref.now(calls - 1) // self.window_ms
                     != ref.now(0) // self.window_ms)
        self.log(f"check: {len(want)} sampled answers over {calls} calls "
                 f"({self.window_calls} in the window, window rolled: "
                 f"{bool(rolled)}); {2 * self.depth * self.width} cells; "
                 f"% over limit in each tenth of the window: "
                 + over_by_tenth(g - self.t.warm_calls, want[:, 0],
                                 self.window_calls))
        return {"answers_wrong": (wrong, 0), "cells_wrong": (cells, 0)}


class Control(Entry):
    """The check's control: the run as the cell makes it, with the
    program's sampled answers and sketch put aside once the window has
    closed and the plain reference's, its estimate computed in bfloat16
    (the configuration states float32), put in their place; `verify()`
    judges them as it judges the program's."""

    def read_state(self) -> None:
        super().read_state()
        calls = self.t.warm_calls + self.window_calls
        ref = self.reference()
        g, lane = self._sampled(calls)
        self._rec = [(0, np.stack(ref.answers(g, lane,
                                              precision="bfloat16"),
                                  axis=1))]
        self._state = ref.tables(calls)
