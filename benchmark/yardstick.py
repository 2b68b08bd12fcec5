"""The benchmark's yardstick: published peaks, the bytes each kernel's work
needs, the sketch's row-column hash and the union of device events.

Frozen here so that a change to the program cannot move its own
measuring stick.  Imports nothing of the program.

- `useful_bytes`: the bytes one K1 dispatch must move for its requests and
  answers, each read or written once (the arithmetic that the port's
  bring-up used to state K1's bound, counting the active lanes alone).
- `sketch_useful_bytes`: the same for one K2 dispatch, with its own copy
  of the count-min sketch's multiply-shift row hash (`row_column`, and
  `row_column_torch` for the reference's large counts on the device).
- `hbm_bytes_per_s`: the H100 SXM's published memory rate; any other card
  is refused.
- `busy_union`: the length of the union of device intervals.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

SXM_NAME = "NVIDIA H100 80GB HBM3"
SXM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

# Odd 64-bit multipliers of the sketch's multiply-shift row hashing
# (splitmix64-style constants), row d using the d-th.
ROW_MULTIPLIERS = (
    0x9E3779B97F4A7C15,
    0xBF58476D1CE4E5B9,
    0x94D049BB133111EB,
    0xD6E8FEB86659FD93,
    0xA5A3564DDF522B81,
    0xC2B2AE3D27D4EB4F,
    0x27D4EB2F165667C5,
    0x165667B19E3779F9,
)


def hbm_bytes_per_s(name: str) -> float:
    """Published memory rate of the card; only the H100 SXM's is known."""
    if name != SXM_NAME:
        raise ValueError(f"no published memory rate on file for {name!r}")
    return SXM_BYTES_PER_S


def useful_bytes(k: int, active: int, found: int, written: int,
                 ways: int) -> int:
    """Bytes one dispatch of k rounds must move for its requests, each read
    or written once: the k `now` words; each active lane's 12 request words
    (96 B), its packed answer (72 B), and the key, expire_at and touched
    words of every way of its bucket (24 B a way); the rest of each found
    lane's row (60 B); and each written row (84 B).  Lanes that carry no
    request need no bytes: the count follows the requests, not the width
    of the round they ride in."""
    return (k * 8 + active * (96 + 72 + 24 * ways) + found * 60
            + written * 84)


def row_column(kh: np.ndarray, d: int, width: int) -> np.ndarray:
    """int64 sketch columns of row d for int64 fingerprints: the top
    log2(width) bits of uint64(kh) * m_d, the multiply wrapping."""
    bits = int(width).bit_length() - 1
    u = np.asarray(kh, dtype=np.int64).view(np.uint64)
    if bits == 0:
        return np.zeros(u.shape, dtype=np.int64)
    with np.errstate(over="ignore"):
        prod = u * np.uint64(ROW_MULTIPLIERS[d])
    return (prod >> np.uint64(64 - bits)).astype(np.int64)


def row_column_torch(kh, d: int, width: int):
    """`row_column` on an int64 tensor, on its device: the product wraps,
    and the shift is made logical by a mask."""
    bits = int(width).bit_length() - 1
    if bits == 0:
        return kh * 0
    m = ROW_MULTIPLIERS[d]
    prod = kh * (m - 2**64 if m >= 2**63 else m)
    return (prod >> (64 - bits)) & ((1 << bits) - 1)


def row_columns(kh: np.ndarray, depth: int, width: int) -> np.ndarray:
    """int64[depth, n] sketch columns of int64 fingerprints."""
    return np.stack([row_column(kh, d, width) for d in range(depth)])


def sketch_useful_bytes(depth: int, width: int, kh: np.ndarray,
                        rolled: bool) -> int:
    """Bytes one K2 dispatch of kh[k, B] must move, each read or written
    once: 24 B a lane (fingerprint, hits, limit, packed answer), 12 B a
    distinct touched (row, column) cell (read cur and prev, write cur), and
    on a dispatch that rolls the window 12 B a cell of the tables (read
    cur, write prev and cur)."""
    kh = np.asarray(kh)
    act = kh.reshape(-1)[kh.reshape(-1) != 0]
    cols = row_columns(act, depth, width) + (
        np.arange(depth, dtype=np.int64)[:, None] * width)
    cells = np.unique(cols).size
    return (24 * kh.size + 12 * int(cells)
            + (12 * depth * width if rolled else 0))


def busy_union(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_gaps(spans: Sequence[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi) that no span covers, as (start, end)."""
    gaps, at = [], lo
    for a, b in sorted(spans):
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(a, b) for a, b in gaps if b > a]
