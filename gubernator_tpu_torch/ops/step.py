"""The decision step in plain PyTorch: batched lookup/insert + branchless
token- and leaky-bucket algebra.

    table, resp = apply_batch_packed_q(table, q, now)

applies one packed round `q` (int64[12, B], DeviceBatch row order) against
the slot table and returns the int64[9, B] packed responses.  This is the
plain version of the hand-written serve kernel
(ops/kernels/serve_kernel.py): the CPU path runs it, and the kernel is held
bit-exact against it on the card.  It is also held bit-exact against
`gubernator_tpu.ops.step.apply_batch_packed_q` by the tests.

Differences from the JAX form, all of which keep the bits:
- The table is updated IN PLACE (index_put_ on the 12 columns) and returned;
  the gathers all happen before the first write.
- float64 -> int64 conversions go through `_trunc_i64`, which clamps
  explicitly: torch's `.to(torch.int64)` does not saturate.
- Each float64 operation is its own torch op, so nothing is contracted
  into a fused multiply-add.

Lookup is W-way set-associative: bucket = key_hash & (num_buckets - 1).
Expired slots do not match.  New keys claim a victim way in up to
INSERT_ROUNDS claim rounds in which the lowest lane wins a contested slot;
lanes left without a slot are answered as transient new items (correct
response, state not persisted).  Each active key appears at most once per
round (the packer's contract).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gubernator_tpu_torch.ops.state import (
    KIND_BUCKET,
    KIND_CACHED_RESP,
    SlotTable,
)

ALGO_TOKEN = 0
ALGO_LEAKY = 1
UNDER = 0
OVER = 1

INSERT_ROUNDS = 3

I64_MAX = 2**63 - 1
I64_MIN = -(2**63)

# Row order of the packed response (apply_batch_packed_q).
RESP_ROWS = (
    "status", "limit", "remaining", "reset_time", "persisted", "found",
    "stored", "cached", "stored_status",
)


class Resp(NamedTuple):
    """Per-lane responses (RateLimitResp, gubernator.proto:169-182), plus
    the columns the JAX engine's fast lane reads (see gubernator_tpu
    ops/step.py Resp)."""

    status: torch.Tensor         # int32[B]
    limit: torch.Tensor          # int64[B]
    remaining: torch.Tensor      # int64[B]
    reset_time: torch.Tensor     # int64[B]
    persisted: torch.Tensor      # bool[B]; False = transient
    found: torch.Tensor          # bool[B]; matched a live slot
    stored: torch.Tensor         # int64[B]; post-step stored remaining
    cached: torch.Tensor         # bool[B]; answered from a cached row
    stored_status: torch.Tensor  # int32[B]; post-step stored status


class DeviceBatchT(NamedTuple):
    """Tensor view of one packed round (ops.batch.DeviceBatch fields)."""

    key_hash: torch.Tensor
    hits: torch.Tensor
    limit: torch.Tensor
    duration: torch.Tensor
    algo: torch.Tensor
    burst: torch.Tensor
    reset_remaining: torch.Tensor
    is_greg: torch.Tensor
    greg_expire: torch.Tensor
    greg_duration: torch.Tensor
    active: torch.Tensor
    use_cached: torch.Tensor


def unpack_batch_q(q: torch.Tensor) -> DeviceBatchT:
    """int64[12, B] round -> typed lanes (bools/int32 travel widened)."""
    return DeviceBatchT(
        key_hash=q[0], hits=q[1], limit=q[2], duration=q[3],
        algo=q[4].to(torch.int32), burst=q[5],
        reset_remaining=q[6] != 0, is_greg=q[7] != 0,
        greg_expire=q[8], greg_duration=q[9],
        active=q[10] != 0, use_cached=q[11] != 0,
    )


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)


def _trunc_i64(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 truncating toward zero, saturating at the int64
    bounds (out of range and +/-inf), NaN -> 0: the JAX engine's
    `_trunc_i64` contract."""
    x = torch.where(torch.isnan(x), 0.0, x)
    hi = x >= 2.0**63
    lo = x <= -(2.0**63)
    y = torch.where(hi | lo, 0.0, x).to(torch.int64)
    y = torch.where(hi, I64_MAX, y)
    return torch.where(lo, I64_MIN, y)


def _sat_add_i64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int64 a+b saturating at the bounds: clamp `b` into the room `a`
    leaves, then add, so no intermediate wraps."""
    room_hi = I64_MAX - torch.clamp(a, min=0)
    room_lo = I64_MIN - torch.clamp(a, max=0)
    return a + torch.minimum(torch.maximum(b, room_lo), room_hi)


def _sat_sub_i64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int64 a-b saturating at the bounds (see _sat_add_i64)."""
    b_lo = torch.clamp(a, min=-1) - I64_MAX
    b_hi = torch.clamp(a, max=-1) - I64_MIN
    return a - torch.minimum(torch.maximum(b, b_lo), b_hi)


def _device_i64(x, dev) -> torch.Tensor:
    """A 0-d int64 tensor of `x` on `dev`: a fill on the device for a host
    number (torch.as_tensor would copy it over and wait for the stream)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int64)
    return torch.full((), int(x), dtype=torch.int64, device=dev)


def _isin(x: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """torch.isin(x, pool) for int64 tensors, by a sort of `pool` and a
    binary search: the same mask, with no host sync (torch.isin's sort
    path waits on the host for two torch.unique calls)."""
    if pool.numel() == 0:
        return torch.zeros_like(x, dtype=torch.bool)
    srt = torch.sort(pool).values
    pos = torch.searchsorted(srt, x).clamp_(max=srt.numel() - 1)
    return srt[pos] == x


def _first_claim(tgt: torch.Tensor, attempt: torch.Tensor) -> torch.Tensor:
    """Of all lanes attempting the same target slot, the lowest lane wins
    (stable sort: equal slots keep lane order).  Returns bool[B]."""
    sent = 1 << 62
    v = torch.where(attempt, tgt, sent)
    v_sorted, order = torch.sort(v, stable=True)
    first = torch.ones_like(attempt)
    first[1:] = v_sorted[1:] != v_sorted[:-1]
    win = torch.zeros_like(attempt)
    win[order] = first & (v_sorted != sent)
    return win


def locate_slots(
    table: SlotTable,
    h: torch.Tensor,
    active: torch.Tensor,
    now: torch.Tensor,
    ways: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Set-associative lookup + insert-victim claim.

    Returns (found, persist, slot, slot_safe): `found` lanes matched a live
    slot at `slot`; `persist & ~found` lanes won an insert victim at
    `slot`; `~persist` lanes could not claim one (transient).
    """
    S = table.key.shape[0]
    nb = S // ways
    if nb & (nb - 1):
        raise ValueError(f"num_buckets ({nb}) must be a power of two")
    B = h.shape[0]
    dev = h.device

    bucket = h & (nb - 1)
    sidx = bucket[:, None] * ways + torch.arange(ways, device=dev)[None, :]

    cand_key = table.key[sidx]          # [B, W]
    cand_expire = table.expire_at[sidx]
    cand_touched = table.touched[sidx]

    keymatch = (cand_key == h[:, None]) & active[:, None]
    live = cand_expire > now
    match = keymatch & live
    found = match.any(dim=1)
    match_slot = bucket * ways + torch.argmax(match.to(torch.int8), dim=1)

    # Victim preference: my own expired slot > empty > other expired >
    # oldest touch.
    empty = cand_key == 0
    mine_stale = keymatch & ~live
    klass = torch.where(
        mine_stale, 0,
        torch.where(empty, 1, torch.where(~live, 2, 3)),
    ).to(torch.int64)
    vscore = klass * (1 << 48) + cand_touched

    need = active & ~found
    inf = 1 << 62
    insert_slot = torch.full((B,), -1, dtype=torch.int64, device=dev)
    won = torch.zeros(B, dtype=torch.bool, device=dev)

    for _ in range(INSERT_ROUNDS):
        # Slots reserved this batch: live matches + already-won inserts.
        reserved = torch.cat([
            torch.where(found, match_slot, -1),
            torch.where(won, insert_slot, -1),
        ])
        blocked = _isin(sidx, reserved)
        vs = torch.where(blocked, inf, vscore)
        vmin = vs.min(dim=1).values
        vslot = bucket * ways + torch.argmin(vs, dim=1)
        attempt = need & ~won & (vmin < inf)
        win_now = _first_claim(vslot, attempt)
        insert_slot = torch.where(win_now, vslot, insert_slot)
        won = won | win_now

    persist = found | won
    slot = torch.where(found, match_slot, torch.where(won, insert_slot, 0))
    slot_safe = torch.clamp(slot, 0, S - 1)
    return found, persist, slot, slot_safe


def apply_batch_impl(
    table: SlotTable,
    batch: DeviceBatchT,
    now,
    ways: int = 8,
) -> Tuple[SlotTable, Resp]:
    """Apply one round IN PLACE; returns (table, responses)."""
    dev = table.key.device
    now = torch.as_tensor(now, dtype=torch.int64, device=dev)

    h = batch.key_hash
    active = batch.active
    found, persist, slot, slot_safe = locate_slots(table, h, active, now, ways)

    # ---- gather current rows -------------------------------------------
    s_algo = table.algo[slot_safe]
    s_kind = table.kind[slot_safe]
    s_limit = table.limit[slot_safe]
    s_dur = table.duration[slot_safe]
    s_rem = table.remaining[slot_safe]
    s_rem_f = table.remaining_f[slot_safe]
    s_t0 = table.t0[slot_safe]
    s_status = table.status[slot_safe]
    s_burst = table.burst[slot_safe]
    s_expire = table.expire_at[slot_safe]

    r_hits, r_lim, r_dur = batch.hits, batch.limit, batch.duration
    r_burst = batch.burst
    is_greg = batch.is_greg
    greg_exp = batch.greg_expire
    greg_dur = batch.greg_duration
    req_token = batch.algo == ALGO_TOKEN
    req_leaky = batch.algo == ALGO_LEAKY
    reset = batch.reset_remaining

    is_bucket_row = found & (s_kind == KIND_BUCKET)
    cached_hit = found & (s_kind == KIND_CACHED_RESP) & batch.use_cached
    tok_clear = req_token & reset & found
    tok_exist = req_token & ~reset & is_bucket_row & (s_algo == ALGO_TOKEN)
    lky_exist = req_leaky & is_bucket_row & (s_algo == ALGO_LEAKY)
    is_new = active & ~tok_clear & ~tok_exist & ~lky_exist

    # ==== token bucket, existing item (algorithms.go:112-195) ===========
    limit_changed = s_limit != r_lim
    rem0 = torch.where(
        limit_changed,
        torch.clamp(_sat_sub_i64(_sat_add_i64(s_rem, r_lim), s_limit), min=0),
        s_rem,
    )
    dur_changed = s_dur != r_dur
    expire1 = torch.where(is_greg, greg_exp, _sat_add_i64(s_t0, r_dur))
    renew = dur_changed & (expire1 <= now)
    te_expire = torch.where(
        dur_changed,
        torch.where(renew, _sat_add_i64(now, r_dur), expire1),
        s_expire,
    )
    te_t0 = torch.where(renew, now, s_t0)
    rem1 = torch.where(renew, r_lim, rem0)

    h0 = r_hits == 0
    over_zero = ~h0 & (rem0 == 0) & (r_hits > 0)
    exact = ~h0 & ~over_zero & (rem1 == r_hits)
    over_more = ~h0 & ~over_zero & ~exact & (r_hits > rem1)
    under = ~h0 & ~over_zero & ~exact & ~over_more

    te_rem = torch.where(exact, 0, torch.where(under, rem1 - r_hits, rem1))
    te_status = torch.where(over_zero, OVER, s_status)
    te_resp_status = torch.where(over_zero | over_more, OVER, s_status)
    te_resp_rem = torch.where(exact | under, te_rem, rem0)
    te_resp_reset = te_expire

    # ==== token bucket, new item (algorithms.go:203-258) ================
    tn_over = r_hits > r_lim
    tn_rem = torch.where(tn_over, r_lim, r_lim - r_hits)
    tn_expire = torch.where(is_greg, greg_exp, _sat_add_i64(now, r_dur))
    tn_resp_status = torch.where(tn_over, OVER, UNDER)

    # ==== leaky bucket, existing item (algorithms.go:327-426) ===========
    lb0 = torch.where(reset & req_leaky, _f64(r_burst), s_rem_f)
    grow = (s_burst != r_burst) & (r_burst > _trunc_i64(lb0))
    lb1 = torch.where(grow, _f64(r_burst), lb0)
    l_dur_c = torch.where(is_greg, greg_exp - now, r_dur)
    safe_lim = torch.where(r_lim == 0, 1, r_lim)
    l_rate = torch.where(
        r_lim == 0,
        0.0,
        torch.where(is_greg, _f64(greg_dur), _f64(r_dur)) / _f64(safe_lim),
    )
    le_expire = torch.where(r_hits != 0, _sat_add_i64(now, l_dur_c), s_expire)
    elapsed = _f64(now - s_t0)
    leak = torch.where(l_rate != 0.0, elapsed / l_rate, 0.0)
    leaked = _trunc_i64(leak) > 0
    lb2 = torch.where(leaked, lb1 + leak, lb1)
    le_t0 = torch.where(leaked, now, s_t0)
    lb3 = torch.where(_trunc_i64(lb2) > r_burst, _f64(r_burst), lb2)
    lrem_i = _trunc_i64(lb3)
    lrate_i = _trunc_i64(l_rate)

    l_over_zero = (lrem_i == 0) & (r_hits > 0)
    l_exact = ~l_over_zero & (lrem_i == r_hits)
    l_over_more = ~l_over_zero & ~l_exact & (r_hits > lrem_i)
    l_take = l_exact | (
        ~l_over_zero & ~l_exact & ~l_over_more & (r_hits != 0)
    )
    lb4 = torch.where(l_take, lb3 - _f64(r_hits), lb3)
    le_resp_rem = torch.where(
        l_exact, 0, torch.where(l_take, _trunc_i64(lb4), lrem_i)
    )
    f_now = _f64(now)
    f_lim = _f64(r_lim)
    f_lrate = _f64(lrate_i)
    le_resp_reset = _trunc_i64(torch.where(
        l_take,
        f_now + (f_lim - _f64(le_resp_rem)) * f_lrate,
        f_now + (f_lim - _f64(lrem_i)) * f_lrate,
    ))
    le_resp_status = torch.where(l_over_zero | l_over_more, OVER, UNDER)

    # ==== leaky bucket, new item (algorithms.go:433-492) ================
    # Rate uses the RAW duration even under Gregorian (algorithms.go:441).
    ln_rate_i = _trunc_i64(
        torch.where(r_lim == 0, 0.0, _f64(r_dur) / _f64(safe_lim))
    )
    ln_dur = torch.where(is_greg, greg_exp - now, r_dur)
    ln_over = r_hits > r_burst
    ln_rem_f = torch.where(ln_over, 0.0, _f64(r_burst - r_hits))
    ln_resp_rem = torch.where(ln_over, 0, r_burst - r_hits)
    ln_resp_reset = _trunc_i64(
        f_now + (f_lim - _f64(ln_resp_rem)) * _f64(ln_rate_i)
    )
    ln_resp_status = torch.where(ln_over, OVER, UNDER)
    ln_expire = _sat_add_i64(now, ln_dur)

    # ==== select per-lane outputs =======================================
    tok_new = is_new & req_token
    lky_new = is_new & req_leaky

    def sel(te, tn, le, ln, clear):
        x = torch.where(tok_exist, te, 0)
        x = torch.where(tok_new, tn, x)
        x = torch.where(lky_exist, le, x)
        x = torch.where(lky_new, ln, x)
        return torch.where(tok_clear, clear, x)

    resp = Resp(
        status=torch.where(
            cached_hit,
            s_status,
            sel(te_resp_status, tn_resp_status, le_resp_status,
                ln_resp_status, UNDER),
        ).to(torch.int32),
        limit=torch.where(cached_hit, s_limit, torch.where(active, r_lim, 0)),
        remaining=torch.where(
            cached_hit,
            s_rem,
            sel(te_resp_rem, tn_rem, le_resp_rem, ln_resp_rem, r_lim),
        ),
        reset_time=torch.where(
            cached_hit,
            s_expire,
            sel(te_resp_reset, tn_expire, le_resp_reset, ln_resp_reset, 0),
        ),
        persisted=persist & active,
        found=found,
        stored=torch.where(
            cached_hit,
            s_rem,
            sel(te_rem, tn_rem, _trunc_i64(lb4), _trunc_i64(ln_rem_f), r_lim),
        ),
        cached=cached_hit,
        stored_status=torch.where(
            cached_hit, s_status, sel(te_status, UNDER, 0, 0, 0)
        ).to(torch.int32),
    )

    # ==== write back (in place) =========================================
    do_write = persist & active & ~cached_hit
    tgt = slot[do_write]

    def put(col: torch.Tensor, val) -> None:
        val = torch.as_tensor(val, device=dev)
        val = val.expand(do_write.shape) if val.dim() == 0 else val
        col[tgt] = val[do_write].to(col.dtype)

    put(table.key, torch.where(tok_clear, 0, h))
    put(table.algo, torch.where(tok_clear, 0, batch.algo))
    put(table.kind, torch.zeros_like(s_kind))
    put(table.limit, sel(r_lim, r_lim, r_lim, r_lim, 0))
    # Leaky-existing stores the RAW duration (algorithms.go:340), leaky-new
    # the computed one (algorithms.go:457).
    put(table.duration, sel(r_dur, r_dur, r_dur, ln_dur, 0))
    put(table.remaining, sel(te_rem, tn_rem, 0, 0, 0))
    put(table.remaining_f, sel(0.0, 0.0, lb4, ln_rem_f, 0.0))
    put(table.t0, sel(te_t0, now, le_t0, now, 0))
    put(table.status, sel(te_status, UNDER, 0, 0, 0))
    put(table.burst, sel(s_burst, 0, r_burst, r_burst, 0))
    put(table.expire_at, sel(te_expire, tn_expire, le_expire, ln_expire, 0))
    put(table.touched, torch.where(tok_clear, 0, now))
    return table, resp


def pack_resp(r: Resp) -> torch.Tensor:
    """Resp -> int64[9, B] in RESP_ROWS order."""
    return torch.stack([getattr(r, f).to(torch.int64) for f in RESP_ROWS])


def apply_batch_packed_q(
    table: SlotTable,
    q: torch.Tensor,
    now,
    ways: int = 8,
) -> Tuple[SlotTable, torch.Tensor]:
    """One packed round: int64[12, B] in, int64[9, B] responses out; the
    table is updated in place and returned."""
    table, r = apply_batch_impl(table, unpack_batch_q(q), now, ways)
    return table, pack_resp(r)


def _put_rows(table: SlotTable, do_write: torch.Tensor, slot: torch.Tensor,
              cols) -> None:
    """Scatter lane values into the table at `slot` for `do_write` lanes
    (the JAX forms' scatter with mode="drop" for the other lanes).
    `cols` maps column name -> per-lane tensor, 0-d tensor or number.
    The lanes are listed once (one host sync), and every column gathers
    its values by that list."""
    idx = do_write.nonzero().squeeze(1)
    tgt = slot[idx]
    for f, val in cols.items():
        col = getattr(table, f)
        if isinstance(val, torch.Tensor) and val.dim() > 0:
            val = val[idx]
        col[tgt] = val.to(col.dtype) if isinstance(val, torch.Tensor) else val


class BucketRows(NamedTuple):
    """A batch of full bucket rows for bulk upsert: the device side of the
    Loader restore stream (workers.go:340-426), of Store.Get seeding
    (algorithms.go:45-51) and of a migrated row's landing.  key_hash 0 =
    inactive lane."""

    key_hash: torch.Tensor     # int64[B]
    algo: torch.Tensor         # int32[B]
    limit: torch.Tensor        # int64[B]
    duration: torch.Tensor     # int64[B]
    remaining: torch.Tensor    # int64[B]
    remaining_f: torch.Tensor  # float64[B]
    t0: torch.Tensor           # int64[B]
    status: torch.Tensor       # int32[B]
    burst: torch.Tensor        # int64[B]
    expire_at: torch.Tensor    # int64[B]


def load_rows(
    table: SlotTable,
    rows: BucketRows,
    now,
    ways: int = 8,
) -> SlotTable:
    """Upsert full KIND_BUCKET rows, updating the table in place and
    returning it.  Keys unique within the batch.  A lane that claims no
    slot (a fourth same-bucket contender past INSERT_ROUNDS, or a full
    bucket of live rows already claimed this batch) is dropped, as the
    JAX form's scatter with mode="drop" drops it."""
    h = rows.key_hash
    now = _device_i64(now, h.device)
    active = h != 0
    _, persist, slot, _ = locate_slots(table, h, active, now, ways)
    _put_rows(table, persist & active, slot, {
        "key": h,
        "algo": rows.algo,
        "kind": KIND_BUCKET,
        "limit": rows.limit,
        "duration": rows.duration,
        "remaining": rows.remaining,
        "remaining_f": rows.remaining_f,
        "t0": rows.t0,
        "status": rows.status,
        "burst": rows.burst,
        "expire_at": rows.expire_at,
        "touched": now,
    })
    return table


def probe_batch(
    table: SlotTable,
    h: torch.Tensor,
    now,
    ways: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read-only batched lookup: (found bool[B], slot int64[B], 0 where not
    found).  The batched analog of a cache-miss test
    (lrucache.go:111-127): Store seeding asks which keys are resident, and
    write-through reads back written rows.  The first matching way wins
    (argmax over an integer cast of the match mask; torch's argmax takes
    the first maximum, as jnp.argmax does)."""
    S = table.key.shape[0]
    nb = S // ways
    bucket = h & (nb - 1)
    sidx = bucket[:, None] * ways + torch.arange(ways, device=h.device)[None, :]
    match = (
        (table.key[sidx] == h[:, None])
        & (h[:, None] != 0)
        & (table.expire_at[sidx] > now)
    )
    found = match.any(dim=1)
    slot = bucket * ways + torch.argmax(match.to(torch.int32), dim=1)
    return found, torch.where(found, slot, 0)


# Row order of gather_rows' packed int output; remaining_f travels as a
# separate float64 column (the JAX package's wire shape).
GATHER_ROW_FIELDS = (
    "found", "kind", "algo", "limit", "duration", "remaining",
    "t0", "status", "burst", "expire_at",
)


def _pack_row_fields(first: torch.Tensor, table: SlotTable,
                     src: torch.Tensor) -> torch.Tensor:
    """int64[10, B]: `first` then the nine row fields of GATHER_ROW_FIELDS
    read at `src`."""
    return torch.stack([
        first.to(torch.int64),
        table.kind[src].to(torch.int64),
        table.algo[src].to(torch.int64),
        table.limit[src],
        table.duration[src],
        table.remaining[src],
        table.t0[src],
        table.status[src].to(torch.int64),
        table.burst[src],
        table.expire_at[src],
    ])


def gather_rows(
    table: SlotTable,
    h: torch.Tensor,
    now,
    ways: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Columnar row read-back: probe + gather every CacheItem field for a
    hash batch as (int64[10, B] in GATHER_ROW_FIELDS order, float64[B]
    remaining_f).  Both are fresh tensors, so a fetch of them queued right
    after this call reads this table version whatever runs later.  h = 0
    lanes read as not found (their other fields are slot 0's)."""
    found, slot = probe_batch(table, h, now, ways)
    return _pack_row_fields(found, table, slot), table.remaining_f[slot]


class CachedRows(NamedTuple):
    """A batch of owner-broadcast statuses (UpdatePeerGlobal rows,
    peers.proto:52-56): key fingerprint + the authoritative RateLimitResp."""

    key_hash: torch.Tensor    # int64[B]; 0 = inactive lane
    algo: torch.Tensor        # int32[B]
    limit: torch.Tensor       # int64[B]
    remaining: torch.Tensor   # int64[B]
    status: torch.Tensor      # int32[B]
    reset_time: torch.Tensor  # int64[B]


def unpack_cached_rows(block: torch.Tensor) -> CachedRows:
    """The store kernel's int64[6, B] block (CachedRows field order,
    ops/kernels/serve_kernel.store_rows) -> CachedRows, algo and status
    narrowed."""
    return CachedRows(
        key_hash=block[0], algo=block[1].to(torch.int32), limit=block[2],
        remaining=block[3], status=block[4].to(torch.int32),
        reset_time=block[5])


def store_cached_rows(
    table: SlotTable,
    rows: CachedRows,
    now,
    ways: int = 8,
) -> SlotTable:
    """Broadcast-receive: upsert KIND_CACHED_RESP rows (the GLOBAL replica
    cache), updating the table in place and returning it.

    The analog of UpdatePeerGlobals -> AddCacheItem (gubernator.go:464-479):
    the stored item IS the response, with ExpireAt = status.ResetTime.
    Keys must be unique within the batch.  Lanes that claim no slot are
    dropped, as the JAX form's scatter with mode="drop" drops them.  The
    plain version of the store kernel (ops/kernels/serve_kernel.store_rows),
    and its path on the CPU."""
    h = rows.key_hash
    now = _device_i64(now, h.device)
    active = h != 0
    _, persist, slot, _ = locate_slots(table, h, active, now, ways)
    _put_rows(table, persist & active, slot, {
        "key": h,
        "algo": rows.algo,
        "kind": KIND_CACHED_RESP,
        "limit": rows.limit,
        "duration": 0,
        "remaining": rows.remaining,
        "remaining_f": 0.0,
        "t0": 0,
        "status": rows.status,
        "burst": 0,
        "expire_at": rows.reset_time,
        "touched": now,
    })
    return table
