"""The sketch tier, plainly: a sliding-window count-min limiter.

Semantics (Cormode and Muthukrishnan's count-min sketch with a sliding
window of two tumbling tables, as the tier's configuration states):
- `depth` rows of `width` int32 counters for the current window and for
  the previous one; windows are aligned to multiples of `window_ms`, and a
  call in a later window moves the current table to the previous one (one
  window on) or clears both (further on).
- Row d's column of a fingerprint is the top log2(width) bits of
  uint64(fingerprint) * m_d (yardstick.row_column, here on the run's
  device).
- A call's lanes go in chunks of `chunk` lanes.  Every lane of a chunk is
  decided against the tables as they stood before the chunk: the estimate
  is min over rows of cur + prev * overlap, in float32, overlap being
  clip(1 - (now - window_start) / window_ms, 0, 1); a lane with hits > 0
  is over when estimate + hits > limit.  Then the chunk's hits are added.
- The answer is (over, max(0, limit - int(estimate) - max(hits, 0)),
  window_start + window_ms).

The traffic cycles a pool of calls, so the counts a sampled lane sees are
counted, not replayed: for each sampled (row, column) the positions of the
pool's lanes that hit it, and whole cycles of the pool times its total.
`precision="bfloat16"` is the control: the estimate's arithmetic rounded
to bfloat16 after each operation.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from benchmark.yardstick import row_column_torch

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), as
    float32."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return r.view(np.float32)


class CmsReference:
    """Answers and tables of a run that cycles `kh`, `hits`, `limits`
    (each [P, n]: P pool calls of n lanes), call g using pool call g % P at
    now = t0 + g * dt."""

    def __init__(self, kh: np.ndarray, hits: np.ndarray, limits: np.ndarray,
                 depth: int, width: int, chunk: int, window_ms: int,
                 t0: int, dt: int = 1, device: str = "cpu") -> None:
        import torch

        self.P, self.n = kh.shape
        self.L = self.P * self.n
        self.kh = kh.reshape(-1)
        hits = np.broadcast_to(hits, kh.shape)
        self.limits = np.broadcast_to(limits, kh.shape).reshape(-1)
        self.depth, self.width, self.chunk = depth, width, chunk
        self.w, self.t0, self.dt = window_ms, t0, dt
        self.hits2d = hits
        # Every lane adds 1 where each carries one hit (None); otherwise the
        # hits of its nonzero fingerprints.
        unit = bool((hits == 1).all() and (kh != 0).all())
        self.add = None if unit else np.where(
            self.kh != 0, hits.reshape(-1), 0).astype(np.int64)
        # The columns of every pool lane, on `device`, where the counts run.
        self.device = device
        kh_t = torch.from_numpy(np.ascontiguousarray(self.kh)).to(device)
        self.cols_t = torch.empty((depth, self.L), dtype=torch.int32,
                                  device=device)
        for d in range(depth):
            self.cols_t[d] = row_column_torch(kh_t, d, width)
        del kh_t
        self.add_t = (None if self.add is None
                      else torch.from_numpy(self.add).to(device))
        self._tot = [None] * depth

    # -- windows ---------------------------------------------------------
    def now(self, g):
        return self.t0 + np.asarray(g, dtype=np.int64) * self.dt

    def window_first_call(self, idx):
        """First call (>= 0) whose `now` lies in window `idx`."""
        first = -(-(idx * self.w - self.t0) // self.dt)
        return np.maximum(first, 0)

    # -- counts ----------------------------------------------------------
    def _watch(self, cells: List[np.ndarray]):
        """Per row: the sorted watched cells, their occurrences' keys
        (rank * L + pool position) and cumulative hits."""
        import torch

        out = []
        for d in range(self.depth):
            watched = torch.from_numpy(np.unique(cells[d])).to(self.device)
            look = torch.full((self.width,), -1, dtype=torch.int64,
                              device=self.device)
            look[watched] = torch.arange(watched.numel(), device=self.device)
            rank = look[self.cols_t[d].long()]
            pos = torch.nonzero(rank >= 0).squeeze(1)
            keys, order = torch.sort(rank[pos] * self.L + pos)
            del rank
            add = (torch.ones_like(pos) if self.add_t is None
                   else self.add_t[pos[order]])
            cum = torch.cat([add.new_zeros(1), torch.cumsum(add, 0)])
            out.append((look.cpu().numpy(), keys.cpu().numpy(),
                        cum.cpu().numpy()))
        return out

    def _prefix(self, watch, d: int, cell: np.ndarray, x: np.ndarray):
        """Hits on row d's `cell` over global lane positions [0, x)."""
        look, keys, cum = watch[d]
        rank = look[cell]
        base = rank * self.L
        lo = np.searchsorted(keys, base)
        tot = cum[np.searchsorted(keys, base + self.L)] - cum[lo]
        part = cum[np.searchsorted(keys, base + x % self.L)] - cum[lo]
        return (x // self.L) * tot + part

    def answers(self, g: np.ndarray, lane: np.ndarray,
                precision: str = "float32") -> Tuple[np.ndarray, ...]:
        """(status, remaining, reset_time) int64 of lanes `lane` of calls
        `g` (equal-length arrays)."""
        import torch

        g = np.asarray(g, dtype=np.int64)
        lane = np.asarray(lane, dtype=np.int64)
        pos = (g % self.P) * self.n + lane
        kh, lim = self.kh[pos], self.limits[pos]
        hits = self.hits2d[pos // self.n, pos % self.n]
        now = self.now(g)
        widx = now // self.w
        start = widx * self.w
        cur_from = self.window_first_call(widx) * self.n
        prev_from = self.window_first_call(widx - 1) * self.n
        first = self.window_first_call(self.now(0) // self.w)
        has_prev = self.window_first_call(widx) > first
        at = g * self.n + (lane // self.chunk) * self.chunk
        pos_t = torch.from_numpy(pos).to(self.device)
        cells = [self.cols_t[d][pos_t].long().cpu().numpy()
                 for d in range(self.depth)]
        watch = self._watch(cells)
        f32 = np.float32
        rnd = _bf16 if precision == "bfloat16" else (lambda v: v)
        overlap = np.clip(
            rnd(f32(1.0) - rnd(rnd((now - start).astype(f32))
                               / rnd(f32(self.w)))), f32(0), f32(1))
        est = None
        for d in range(self.depth):
            cell = cells[d]
            cur = (self._prefix(watch, d, cell, at)
                   - self._prefix(watch, d, cell, cur_from))
            prev = np.where(
                has_prev,
                self._prefix(watch, d, cell, cur_from)
                - self._prefix(watch, d, cell, prev_from), 0)
            read = rnd(rnd(cur.astype(f32))
                       + rnd(rnd(prev.astype(f32)) * overlap))
            est = read if est is None else np.minimum(est, read)
        active = kh != 0
        est = np.where(active, est, f32(0))
        h32 = np.clip(hits, I32_MIN, I32_MAX)
        l32 = np.clip(lim, I32_MIN, I32_MAX)
        over = active & (rnd(est + rnd(h32.astype(f32)))
                         > rnd(l32.astype(f32))) & (h32 > 0)
        est_i = np.clip(est.astype(np.float64), I32_MIN, I32_MAX).astype(
            np.int64)
        remaining = np.maximum(0, l32 - est_i - np.maximum(h32, 0))
        reset = start + self.w
        return over.astype(np.int64), remaining, reset

    def _range_counts(self, a: int, b: int) -> np.ndarray:
        """int64[depth, width]: hits over global lane positions [a, b)."""
        out = np.zeros((self.depth, self.width), dtype=np.int64)
        if b <= a:
            return out
        cycles, a2 = divmod(b - a, self.L)
        spans = []
        lo = a % self.L
        if a2:
            hi = lo + a2
            spans = [(lo, min(hi, self.L))] + (
                [(0, hi - self.L)] if hi > self.L else [])
        for d in range(self.depth):
            if cycles:
                if self._tot[d] is None:
                    self._tot[d] = self._count(d, 0, self.L)
                out[d] += cycles * self._tot[d]
            for s, e in spans:
                out[d] += self._count(d, s, e)
        return out

    def _count(self, d: int, s: int, e: int) -> np.ndarray:
        """int64[width]: row d's hits over pool positions [s, e)."""
        import torch

        c = torch.bincount(
            self.cols_t[d, s:e], minlength=self.width,
            weights=None if self.add_t is None
            else self.add_t[s:e].double())
        return c.round().to(torch.int64).cpu().numpy()

    def tables(self, calls: int) -> Dict[str, np.ndarray]:
        """cur, prev and window_start after calls 0..calls-1."""
        last = calls - 1
        widx = int(self.now(last) // self.w)
        cur_from = int(self.window_first_call(widx))
        prev_from = int(self.window_first_call(widx - 1))
        first = int(self.window_first_call(int(self.now(0) // self.w)))
        cur = self._range_counts(cur_from * self.n, calls * self.n)
        prev = (self._range_counts(prev_from * self.n, cur_from * self.n)
                if cur_from > first else np.zeros_like(cur))
        return {"cur": cur, "prev": prev,
                "window_start": np.int64(widx * self.w)}
