"""Count-min-sketch approximate limiter, as plain PyTorch.

The port of gubernator_tpu/ops/sketch.py.  When the key cardinality outgrows
exact per-key slots (the 100M-key deployment), admission control degrades to
a sliding-window count-min sketch: O(depth x width) memory whatever the key
count, with a one-sided error (it over-counts, never under-counts), so it
can only over-limit hot tails.

- State is two [D, W] int32 sketches, current and previous window, plus the
  window start.  Estimated rate = cur + prev * overlap, in float32.
- Row columns come from the key fingerprint by multiply-shift hashing with
  D odd 64-bit multipliers.
- A step decides every lane against the sketch as it stood BEFORE the
  batch, then adds the active lanes' hits (negative ones too) into their D
  cells; duplicate keys share one estimate and their hits sum.

`cms_step_scatter_impl` is the plain version of K2, the hand-written merge
kernel (csrc/cms_kernel.cu, ops/kernels/cms_kernel.py); `multi_step` is its
k-chunk form.  These functions never modify the state they are given: they
return new tensors (the kernel, by contrast, updates the tables in place).
The JAX package's one-hot `cms_step_impl` stays there, as the tests'
semantic oracle.

Integer semantics follow the JAX form exactly: the 64-bit multiply wraps and
the shift is logical (torch's int64 `>>` is arithmetic, so the column is
masked after it); `elapsed % w` is a floor-mod; cell adds wrap in int32; the
float estimate converts to int32 toward zero and saturates, as XLA's convert
does.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

DEFAULT_DEPTH = 4
DEFAULT_WIDTH = 8192

INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)

# Odd 64-bit multipliers for multiply-shift row hashing (splitmix64-style
# constants).
_ROW_MULTIPLIERS = (
    0x9E3779B97F4A7C15,
    0xBF58476D1CE4E5B9,
    0x94D049BB133111EB,
    0xD6E8FEB86659FD93,
    0xA5A3564DDF522B81,
    0xC2B2AE3D27D4EB4F,
    0x27D4EB2F165667C5,
    0x165667B19E3779F9,
)


def _as_int64(u: int) -> int:
    """Two's-complement int64 value of an unsigned 64-bit constant."""
    return u - (1 << 64) if u >= 1 << 63 else u


class SketchState(NamedTuple):
    """Sliding-window CMS state, all on one device."""

    cur: torch.Tensor           # int32[D, W]: counts in the current window
    prev: torch.Tensor          # int32[D, W]: counts in the previous window
    window_start: torch.Tensor  # int64 scalar: unix ms of the window start
    window_ms: torch.Tensor     # int64 scalar: window length


def init_sketch(
    depth: int = DEFAULT_DEPTH,
    width: int = DEFAULT_WIDTH,
    window_ms: int = 1000,
    device=None,
) -> SketchState:
    """An empty sketch on `device` (None means "cuda")."""
    if not 1 <= depth <= len(_ROW_MULTIPLIERS):
        raise ValueError(f"depth must be 1..{len(_ROW_MULTIPLIERS)}")
    if width <= 0 or width & (width - 1):
        raise ValueError("width must be a power of two")
    if window_ms <= 0:
        raise ValueError("window_ms must be positive")
    dev = torch.device(device or "cuda")

    def z() -> torch.Tensor:
        return torch.zeros((depth, width), dtype=torch.int32, device=dev)

    return SketchState(
        cur=z(),
        prev=z(),
        window_start=torch.zeros((), dtype=torch.int64, device=dev),
        window_ms=torch.tensor(window_ms, dtype=torch.int64, device=dev),
    )


def clone_sketch(state: SketchState) -> SketchState:
    return SketchState(*(t.clone() for t in state))


def row_columns(key_hash: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """Per-row bucket columns int32[D, ...] from int64 fingerprints.

    Multiply-shift: col_d = (uint64(h) * m_d) >> (64 - log2(W)), the
    multiply wrapping and the shift logical."""
    bits = width.bit_length() - 1
    h = key_hash.to(torch.int64)
    cols = []
    for d in range(depth):
        if bits == 0:  # a shift by 64 leaves nothing
            cols.append(torch.zeros_like(h, dtype=torch.int32))
            continue
        prod = h * _as_int64(_ROW_MULTIPLIERS[d])
        cols.append(((prod >> (64 - bits)) & (width - 1)).to(torch.int32))
    return torch.stack(cols)


def _now_tensor(now, device) -> torch.Tensor:
    return torch.as_tensor(now, dtype=torch.int64).to(device)


def _overlap(now: torch.Tensor, start: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """clip(1 - f32(now - start) / f32(w), 0, 1), in float32."""
    frac = 1.0 - (now - start).to(torch.float32) / w.to(torch.float32)
    return frac.clamp(0.0, 1.0)


def _rotate(
    state: SketchState, now
) -> Tuple[SketchState, torch.Tensor]:
    """Advance the sliding window.  One step behind -> cur becomes prev;
    further behind -> both clear.  Returns (state, overlap_weight_f32)."""
    now = _now_tensor(now, state.cur.device)
    elapsed = now - state.window_start
    w = state.window_ms
    in_window = elapsed < w
    one_behind = (elapsed >= w) & (elapsed < 2 * w)
    new_start = torch.where(
        in_window, state.window_start, now - torch.remainder(elapsed, w)
    )
    z = torch.zeros_like(state.cur)
    new_prev = torch.where(
        in_window, state.prev, torch.where(one_behind, state.cur, z)
    )
    new_cur = torch.where(in_window, state.cur, z)
    return (
        SketchState(new_cur, new_prev, new_start, state.window_ms),
        _overlap(now, new_start, w),
    )


def _rotate_cond(
    state: SketchState, now
) -> Tuple[SketchState, torch.Tensor]:
    """_rotate with the table rewrite taken only when the window rolls (a
    host branch: on a CUDA state it reads two scalars back).  Same outcomes
    as _rotate."""
    now = _now_tensor(now, state.cur.device)
    elapsed = now - state.window_start
    w = state.window_ms
    if not bool(elapsed < w):
        one_behind = bool(elapsed < 2 * w)  # elapsed >= w here
        state = SketchState(
            cur=torch.zeros_like(state.cur),
            prev=state.cur if one_behind else torch.zeros_like(state.cur),
            window_start=now - torch.remainder(elapsed, w),
            window_ms=state.window_ms,
        )
    return state, _overlap(now, state.window_start, w)


def _f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 -> int32 convert: toward zero, saturating (float64
    holds both int32 bounds and every float32 exactly)."""
    return x.to(torch.float64).clamp(INT32_MIN, INT32_MAX).to(torch.int32)


def cms_step_scatter_impl(
    state: SketchState,
    key_hash: torch.Tensor,  # int64[B]; 0 = inactive lane
    hits: torch.Tensor,      # int32[B]
    limit: torch.Tensor,     # int32[B], per-lane window limit
    now,                     # int ms
) -> Tuple[SketchState, torch.Tensor, torch.Tensor]:
    """One batch: returns (state', over_limit bool[B], estimate int32[B]).

    Gather reads from the pre-batch sketch, then one scatter-add of the
    active lanes' hits (duplicate keys' hits sum in int32, wrapping).
    Over-limited hits are still counted, as in CMS-limiter practice."""
    depth, width = state.cur.shape
    state, overlap = _rotate_cond(state, now)
    active = key_hash != 0
    cols = row_columns(key_hash, depth, width).to(torch.int64)  # [D, B]

    rc = torch.gather(state.cur, 1, cols)
    rp = torch.gather(state.prev, 1, cols)
    reads = rc.to(torch.float32) + rp.to(torch.float32) * overlap
    estimate = torch.where(active, torch.amin(reads, dim=0), 0.0)  # [B]

    over = active & (
        estimate + hits.to(torch.float32) > limit.to(torch.float32)
    ) & (hits > 0)

    add = torch.where(active, hits, 0).to(torch.int32)            # [B]
    rows = torch.arange(depth, device=cols.device)[:, None] * width
    new_cur = state.cur.clone()
    new_cur.view(-1).index_add_(
        0, (rows + cols).reshape(-1), add.expand(depth, -1).reshape(-1)
    )
    return (
        SketchState(new_cur, state.prev, state.window_start, state.window_ms),
        over,
        _f32_to_i32(estimate),
    )


def multi_step(
    state: SketchState,
    kh: torch.Tensor,    # int64[k, B]
    hits: torch.Tensor,  # int32[k, B]
    lim: torch.Tensor,   # int32[k, B]
    now,
) -> Tuple[SketchState, torch.Tensor]:
    """k chunks in order at one `now`, each seeing the previous chunk's
    adds (the JAX package's `make_multi_step(cms_step_scatter_impl)`).
    Returns (state', packed int32[k, 2, B]): over, then estimate."""
    k, B = kh.shape
    packed = torch.empty((k, 2, B), dtype=torch.int32, device=kh.device)
    for c in range(k):
        state, over, est = cms_step_scatter_impl(
            state, kh[c], hits[c], lim[c], now)
        packed[c, 0] = over.to(torch.int32)
        packed[c, 1] = est
    return state, packed
