"""The exact tier, plainly: a W-way set-associative table with LRU victims
and the token and leaky bucket algebra of gubernator's algorithms.go.

One bucket is simulated at a time (every decision of a round depends only
on its own bucket), in Python scalars, so a sample of buckets can follow a
whole run.  A row is the 12 words the device table keeps for a slot, in
this order:

    key, algo, kind, limit, duration, remaining, remaining_f, t0, status,
    burst, expire_at, touched

Lookup: a key matches a way holding its fingerprint whose expire_at is
after `now`.  A key that matches none claims a victim way, preferring its
own expired way, then an empty one, then another expired one, then the
least recently touched (ties to the lowest way).  Ways matched or claimed
in this round are off limits; claims run in up to three rounds, and in
each the lowest lane wins a slot that several lanes want.  A lane left
without a way is answered as a new item and leaves no row.

The algebra is a frozen copy of the sequential model's (core/pymodel.py
in the program, itself a re-derivation of algorithms.go:31-492), written
here over the row layout above.  `fdt` is the floating type of the leaky
bucket's arithmetic: float64 as the configuration states; the control
passes float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

I64_MAX = 2**63 - 1
I64_MIN = -(2**63)
TOKEN, LEAKY = 0, 1
UNDER, OVER = 0, 1
INSERT_ROUNDS = 3
ROW_FIELDS = ("key", "algo", "kind", "limit", "duration", "remaining",
              "remaining_f", "t0", "status", "burst", "expire_at", "touched")
(KEY, ALGO, KIND, LIMIT, DURATION, REMAINING, REMAINING_F, T0, STATUS,
 BURST, EXPIRE, TOUCHED) = range(12)
_INF = 1 << 62


def _clamp(x: int) -> int:
    return I64_MAX if x > I64_MAX else I64_MIN if x < I64_MIN else x


def _sat_add(a: int, b: int) -> int:
    return _clamp(a + b)


def _sat_sub(a: int, b: int) -> int:
    return _clamp(a - b)


def _trunc(x) -> int:
    """int64(x) toward zero, saturating at the bounds, NaN -> 0."""
    x = float(x)
    if math.isnan(x):
        return 0
    if x >= 2.0**63:
        return I64_MAX
    if x <= -(2.0**63):
        return I64_MIN
    return int(x)


def empty_row() -> list:
    return [0, 0, 0, 0, 0, 0, 0.0, 0, 0, 0, 0, 0]


def decide(row, found: bool, req, now: int, fdt=np.float64):
    """One lane: (status, limit, remaining, reset_time) and the row to
    write (None for none).  `row` is the lane's way before the round (any
    row when not found); `req` is (h, hits, limit, duration, algo, burst,
    reset)."""
    h, hits, lim, dur, algo, burst, reset = req
    f = fdt
    is_bucket = found and row[KIND] == 0
    if algo == TOKEN and reset and found:
        # RESET_REMAINING on a live row (algorithms.go:78-90): the row goes.
        return (UNDER, lim, lim, 0), empty_row()
    if algo == TOKEN and is_bucket and row[ALGO] == TOKEN:
        # Existing token bucket (algorithms.go:112-195).
        s_rem, s_lim, s_t0 = row[REMAINING], row[LIMIT], row[T0]
        rem0 = s_rem
        if s_lim != lim:
            rem0 = max(_sat_sub(_sat_add(s_rem, lim), s_lim), 0)
        expire, t0, rem1 = row[EXPIRE], s_t0, rem0
        if row[DURATION] != dur:
            expire = _sat_add(s_t0, dur)
            if expire <= now:
                expire, t0, rem1 = _sat_add(now, dur), now, lim
        st = row[STATUS]
        status, store_st, store_rem, resp_rem = st, st, rem1, rem0
        if hits == 0:
            pass
        elif rem0 == 0 and hits > 0:
            status = store_st = OVER
        elif rem1 == hits:
            store_rem = resp_rem = 0
        elif hits > rem1:
            status = OVER
        else:
            store_rem = resp_rem = rem1 - hits
        new = [h, TOKEN, 0, lim, dur, store_rem, 0.0, t0, store_st,
               row[BURST], expire, now]
        return (status, lim, resp_rem, expire), new
    if algo == LEAKY and is_bucket and row[ALGO] == LEAKY:
        # Existing leaky bucket (algorithms.go:327-426).
        rem = f(burst) if reset else f(row[REMAINING_F])
        if row[BURST] != burst and burst > _trunc(rem):
            rem = f(burst)
        rate = f(0.0) if lim == 0 else f(dur) / f(lim)
        expire = _sat_add(now, dur) if hits != 0 else row[EXPIRE]
        elapsed = f(now - row[T0])
        leak = elapsed / rate if rate != 0 else f(0.0)
        t0 = row[T0]
        if _trunc(leak) > 0:
            rem = rem + leak
            t0 = now
        if _trunc(rem) > burst:
            rem = f(burst)
        rem_i, rate_i = _trunc(rem), _trunc(rate)
        status, take, exact = UNDER, False, False
        if rem_i == 0 and hits > 0:
            status = OVER
        elif rem_i == hits:
            take = exact = True
        elif hits > rem_i:
            status = OVER
        elif hits != 0:
            take = True
        if take:
            rem = rem - f(hits)
        resp_rem = 0 if exact else _trunc(rem) if take else rem_i
        reset_t = _trunc(f(now) + (f(lim) - f(resp_rem)) * f(rate_i))
        new = [h, LEAKY, 0, lim, dur, 0, float(rem), t0, 0, burst,
               expire, now]
        return (status, lim, resp_rem, reset_t), new
    if algo == TOKEN:
        # New token bucket (algorithms.go:203-258).
        over = hits > lim
        rem = lim if over else lim - hits
        expire = _sat_add(now, dur)
        new = [h, TOKEN, 0, lim, dur, rem, 0.0, now, UNDER, 0, expire, now]
        return (OVER if over else UNDER, lim, rem, expire), new
    # New leaky bucket (algorithms.go:433-492).
    rate_i = _trunc(f(0.0) if lim == 0 else f(dur) / f(lim))
    over = hits > burst
    resp_rem = 0 if over else burst - hits
    rem_f = 0.0 if over else float(f(burst - hits))
    reset_t = _trunc(f(now) + (f(lim) - f(resp_rem)) * f(rate_i))
    new = [h, LEAKY, 0, lim, dur, 0, rem_f, now, 0, burst,
           _sat_add(now, dur), now]
    return (OVER if over else UNDER, lim, resp_rem, reset_t), new


def apply_round(ways: List[list], lanes: Sequence[Tuple[int, tuple]],
                now: int, fdt=np.float64) -> List[tuple]:
    """Apply one round's lanes of one bucket (sorted by lane, keys
    distinct) to its `ways` rows in place; returns each lane's answer."""
    W = len(ways)
    looks = []
    reserved = set()
    for _, req in lanes:
        h = req[0]
        match, vscore = -1, []
        for w, row in enumerate(ways):
            mine = row[KEY] == h
            live = row[EXPIRE] > now
            if mine and live and match < 0:
                match = w
            klass = (0 if mine and not live else 1 if row[KEY] == 0
                     else 2 if not live else 3)
            vscore.append(klass * (1 << 48) + row[TOUCHED])
        if match >= 0:
            reserved.add(match)
        looks.append((match, vscore))
    slot = [m for m, _ in looks]
    for _ in range(INSERT_ROUNDS):
        wants: Dict[int, int] = {}
        for i, (match, vscore) in enumerate(looks):
            if match >= 0 or slot[i] >= 0:
                continue
            best, at = _INF, -1
            for w in range(W):
                if w not in reserved and vscore[w] < best:
                    best, at = vscore[w], w
            if at >= 0 and at not in wants:
                wants[at] = i
        for w, i in wants.items():
            slot[i] = w
            reserved.add(w)
    out, writes = [], []
    for i, (_, req) in enumerate(lanes):
        s = slot[i]
        found = looks[i][0] >= 0
        row = ways[s] if s >= 0 else None
        ans, new = decide(row if found else empty_row(), found, req, now,
                          fdt)
        out.append(ans)
        if s >= 0:
            writes.append((s, new))
    for s, new in writes:
        ways[s] = new
    return out


def replay(events: np.ndarray, reqs: Dict[str, np.ndarray], ways: int,
           fdt=np.float64) -> Tuple[np.ndarray, Dict[int, List[list]]]:
    """Replay sampled lanes from an empty table.

    `events` is an int64[n, 4] array of (call, now, bucket, lane), sorted
    by call, then bucket, then lane; `reqs` holds the lanes' request
    columns (key_hash, hits, limit, duration, algo, burst, reset), aligned
    with `events`.  Returns the answers as int64[n, 4] (status, limit,
    remaining, reset_time) in the order of `events`, and each bucket's
    rows at the end."""
    n = len(events)
    answers = np.zeros((n, 4), dtype=np.int64)
    table: Dict[int, List[list]] = {}
    cols = [reqs[f].tolist() for f in ("key_hash", "hits", "limit",
                                       "duration", "algo", "burst",
                                       "reset")]
    call, now, bucket, lane = (events[:, j].tolist() for j in range(4))
    i = 0
    while i < n:
        j = i + 1
        while j < n and call[j] == call[i] and bucket[j] == bucket[i]:
            j += 1
        rows = table.get(bucket[i])
        if rows is None:
            rows = table[bucket[i]] = [empty_row() for _ in range(ways)]
        lanes = [(lane[m], tuple(c[m] for c in cols)) for m in range(i, j)]
        for m, ans in zip(range(i, j), apply_round(rows, lanes, now[i],
                                                   fdt)):
            answers[m] = ans
        i = j
    return answers, table
