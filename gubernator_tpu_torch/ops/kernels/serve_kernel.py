"""K1, the persistent decision kernel: its wrapper and launch count.

    table, resps[k, 9, B], seq' = persistent_serve_step(
        table, qs[k, 12, B], nows[k], seq, ways, claim)

Replaces the Pallas kernel of gubernator_tpu/ops/pallas/serve_kernel.py
(`_serve_kernel`, `persistent_serve_step_impl`): one dispatch drains k
packed rounds in order.  It is two launches on the caller's stream: one
bins each round's lanes by the block that owns their bucket (owner =
bucket % `owners(device)`), and one in which each owner block drains every
round over its own lanes with block barriers only (csrc/serve_kernel.cu
says how).  The contract is `ops/ring.ring_step`'s, which is its plain
version; `ops/ring.owner_partition` is the plain form of the binning.

The table is updated IN PLACE (at 2^24 slots a copy would be 1.4 GB) and
returned.  `claim` is the int32[S] claim-word buffer, all INT32_MAX between
launches.  A launch on the card needs the caller's buffer (the backend owns
one); the plain path on the CPU takes none.  `scratch` is an optional int32
buffer of at least `scratch_words(dev, k, B)` words the launch may use for
its lane lists (a caller that reuses one, in stream order, saves the
allocation); without one the wrapper allocates it.

Tensors on the CPU take the plain `ring_step`.  Tensors on a CUDA device
launch the kernel, or raise: there is no fallback.  `launches` counts one
per dispatch of the kernel (its two launches together), and nothing else.

The store, the GLOBAL replica upsert, is K1's dispatch with a row write in
place of the decision step:

    table = store_rows(table, rows[6, L], now, ways, claim, scratch)

writes each active lane's owner-broadcast row (CachedRows order: key hash,
algo, limit, remaining, status, reset time; key 0 = inactive) as a
KIND_CACHED_RESP row, as `ops/step.store_cached_rows`, its plain version,
does; a lane that claims no slot is dropped.  It replaces no Pallas kernel
(the JAX form is plain XLA).  Its scratch is K1's for one round of L lanes.
`store_launches` counts its dispatches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gubernator_tpu_torch.ops.kernels import check_tensor, device_index
from gubernator_tpu_torch.ops.ring import ring_step
from gubernator_tpu_torch.ops.state import COLUMN_DTYPES, SlotTable
from gubernator_tpu_torch.ops.step import store_cached_rows, unpack_cached_rows

INT32_MAX = 2**31 - 1
MAX_LANES = 1 << 21  # B: 2048 bins of 1024 lanes a round

launches = 0
store_launches = 0

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (at first use) and bind csrc/serve_kernel.cu."""
    global _lib
    if _lib is None:
        from gubernator_tpu_torch.ops.kernels.build import build

        lib = build("serve_kernel").lib
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gub_serve_launch.argtypes = [
            i32, vp, ctypes.POINTER(vp), i64, i32,
            vp, vp, vp, vp, vp, vp, vp, i64, i32, i32,
        ]
        lib.gub_serve_launch.restype = i32
        lib.gub_serve_owners.argtypes = [i32]
        lib.gub_serve_owners.restype = i32
        lib.gub_serve_scratch_words.argtypes = [i32, i32, i32]
        lib.gub_serve_scratch_words.restype = i64
        lib.gub_store_launch.argtypes = [
            i32, vp, ctypes.POINTER(vp), i64, i32, vp, i64, vp, vp, i64, i32,
        ]
        lib.gub_store_launch.restype = i32
        _lib = lib
    return _lib


def owners(dev) -> int:
    """G, the number of owner blocks K1 uses on CUDA device `dev`: the walk
    blocks that fit on the card at once.  Lane i of a round belongs to
    owner (h_i & (num_buckets - 1)) % G."""
    g = library().gub_serve_owners(device_index(torch.device(dev)))
    if g <= 0:
        raise RuntimeError(f"serve kernel owners: cudaError {-g}")
    return g


def scratch_words(dev, k: int, B: int) -> int:
    """int32 words of scratch one dispatch of k rounds of B lanes needs."""
    words = library().gub_serve_scratch_words(
        device_index(torch.device(dev)), k, B)
    if words < 0:
        raise RuntimeError(f"serve kernel scratch: cudaError {-words}")
    return words


def new_claim_buffer(num_slots: int, device) -> torch.Tensor:
    return torch.full(
        (num_slots,), INT32_MAX, dtype=torch.int32, device=device
    )


def _check_table(table: SlotTable, ways: int) -> None:
    """Raise unless the 12 columns are contiguous [S] tensors of their
    dtypes on one device and S / ways is a power of two."""
    dev, S = table.key.device, table.key.shape[0]
    for f, dt in COLUMN_DTYPES.items():
        check_tensor(f"table.{f}", getattr(table, f), dt, (S,), dev)
    if S % ways or (S // ways) & (S // ways - 1):
        raise ValueError(f"num_slots/ways ({S}/{ways}) must be a power of two")


def _check_card(dev, S: int, B: int, claim) -> None:
    """What a launch on the card needs beyond the inputs' shapes: a CUDA
    device, sizes the kernel takes and the caller's claim words."""
    if dev.type != "cuda":
        raise ValueError(f"no serve kernel for device {dev}")
    if S > INT32_MAX or B > MAX_LANES:
        raise ValueError(f"num_slots must fit int32 and B be at most "
                         f"{MAX_LANES}")
    if claim is None:
        raise ValueError("claim: a launch on the card needs the caller's "
                         "int32[num_slots] claim-word buffer")
    check_tensor("claim", claim, torch.int32, (S,), dev)


def _scratch(dev, k: int, B: int, scratch) -> torch.Tensor:
    """The caller's scratch buffer, checked to hold scratch_words(dev, k,
    B) words, or a new one."""
    words = scratch_words(dev, k, B)
    # Lane lists, per-entry scratch and per-(round, bin, owner) sub-lists.
    if scratch is None:
        return torch.empty(max(words, 1), dtype=torch.int32, device=dev)
    if (scratch.dtype != torch.int32 or scratch.device != dev
            or not scratch.is_contiguous() or scratch.numel() < words):
        raise ValueError(f"scratch: expected a contiguous int32 buffer of "
                         f">= {words} words on {dev}")
    return scratch


def persistent_serve_step(
    table: SlotTable,
    qs: torch.Tensor,
    nows: torch.Tensor,
    seq: torch.Tensor,
    ways: int = 8,
    claim: Optional[torch.Tensor] = None,
    scratch: Optional[torch.Tensor] = None,
) -> Tuple[SlotTable, torch.Tensor, torch.Tensor]:
    """Drain k packed rounds; returns (table, int64[k, 9, B], seq + k)."""
    global launches
    dev = table.key.device
    S = table.key.shape[0]
    if qs.dim() != 3 or qs.shape[1] != 12:
        raise ValueError(f"qs: shape {tuple(qs.shape)}, expected [k, 12, B]")
    k, _, B = qs.shape
    _check_table(table, ways)
    check_tensor("qs", qs, torch.int64, (k, 12, B), dev)
    check_tensor("nows", nows, torch.int64, (k,), dev)
    if seq.dtype != torch.int64 or seq.numel() != 1 or seq.device != dev:
        raise ValueError("seq: expected one int64 on the table's device")
    if dev.type == "cpu":
        return ring_step(table, qs, nows, seq, ways)
    _check_card(dev, S, B, claim)

    resps = torch.empty((k, 9, B), dtype=torch.int64, device=dev)
    seq_out = torch.empty_like(seq)
    if k == 0:
        seq_out.copy_(seq)
        return table, resps, seq_out
    scratch = _scratch(dev, k, B, scratch)
    cols = (ctypes.c_void_p * 12)(*[c.data_ptr() for c in table])
    err = library().gub_serve_launch(
        device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
        cols, S, ways,
        qs.data_ptr(), nows.data_ptr(), seq.data_ptr(), seq_out.data_ptr(),
        resps.data_ptr(), claim.data_ptr(), scratch.data_ptr(),
        scratch.numel(), k, B,
    )
    if err != 0:
        raise RuntimeError(f"serve kernel launch failed: cudaError {err}")
    launches += 1
    return table, resps, seq_out


def store_rows(
    table: SlotTable,
    rows: torch.Tensor,
    now: int,
    ways: int = 8,
    claim: Optional[torch.Tensor] = None,
    scratch: Optional[torch.Tensor] = None,
) -> SlotTable:
    """Upsert one block of owner-broadcast rows, int64[6, L] in CachedRows
    order (keys unique, key 0 = inactive), as KIND_CACHED_RESP rows touched
    at `now` (a host int: it rides as a launch argument); the table is
    updated in place and returned.  A `claim` buffer given is checked on
    either path; the CPU's plain path does not use it."""
    global store_launches
    dev = table.key.device
    S = table.key.shape[0]
    if rows.dim() != 2 or rows.shape[0] != 6:
        raise ValueError(f"rows: shape {tuple(rows.shape)}, expected [6, L]")
    L = rows.shape[1]
    _check_table(table, ways)
    check_tensor("rows", rows, torch.int64, (6, L), dev)
    if claim is not None:
        check_tensor("claim", claim, torch.int32, (S,), dev)
    if dev.type == "cpu":
        return store_cached_rows(table, unpack_cached_rows(rows), now, ways)
    _check_card(dev, S, L, claim)
    if isinstance(now, torch.Tensor):
        raise TypeError("now: expected a host int (reading a device "
                        "tensor would make the host wait on the card)")
    scratch = _scratch(dev, 1, L, scratch)
    cols = (ctypes.c_void_p * 12)(*[c.data_ptr() for c in table])
    err = library().gub_store_launch(
        device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
        cols, S, ways, rows.data_ptr(), int(now), claim.data_ptr(),
        scratch.data_ptr(), scratch.numel(), L,
    )
    if err != 0:
        raise RuntimeError(f"store kernel launch failed: cudaError {err}")
    store_launches += 1
    return table
