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
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gubernator_tpu_torch.ops.kernels import check_tensor, device_index
from gubernator_tpu_torch.ops.ring import ring_step
from gubernator_tpu_torch.ops.state import COLUMN_DTYPES, SlotTable

INT32_MAX = 2**31 - 1
MAX_LANES = 1 << 21  # B: 2048 bins of 1024 lanes a round

launches = 0

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
    for f, dt in COLUMN_DTYPES.items():
        check_tensor(f"table.{f}", getattr(table, f), dt, (S,), dev)
    check_tensor("qs", qs, torch.int64, (k, 12, B), dev)
    check_tensor("nows", nows, torch.int64, (k,), dev)
    if seq.dtype != torch.int64 or seq.numel() != 1 or seq.device != dev:
        raise ValueError("seq: expected one int64 on the table's device")
    if S % ways or (S // ways) & (S // ways - 1):
        raise ValueError(f"num_slots/ways ({S}/{ways}) must be a power of two")
    if dev.type == "cpu":
        return ring_step(table, qs, nows, seq, ways)
    if dev.type != "cuda":
        raise ValueError(f"no serve kernel for device {dev}")
    if S > INT32_MAX or B > MAX_LANES:
        raise ValueError(f"num_slots must fit int32 and B be at most "
                         f"{MAX_LANES}")
    if claim is None:
        raise ValueError("claim: a launch on the card needs the caller's "
                         "int32[num_slots] claim-word buffer")
    check_tensor("claim", claim, torch.int32, (S,), dev)

    resps = torch.empty((k, 9, B), dtype=torch.int64, device=dev)
    seq_out = torch.empty_like(seq)
    if k == 0:
        seq_out.copy_(seq)
        return table, resps, seq_out
    lib = library()
    index = device_index(dev)
    words = scratch_words(dev, k, B)
    # Lane lists, per-entry scratch and per-(round, bin, owner) sub-lists.
    if scratch is None:
        scratch = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
    elif (scratch.dtype != torch.int32 or scratch.device != dev
          or not scratch.is_contiguous() or scratch.numel() < words):
        raise ValueError(f"scratch: expected a contiguous int32 buffer of "
                         f">= {words} words on {dev}")
    words = scratch.numel()
    cols = (ctypes.c_void_p * 12)(*[c.data_ptr() for c in table])
    err = lib.gub_serve_launch(
        index, torch.cuda.current_stream(dev).cuda_stream,
        cols, S, ways,
        qs.data_ptr(), nows.data_ptr(), seq.data_ptr(), seq_out.data_ptr(),
        resps.data_ptr(), claim.data_ptr(), scratch.data_ptr(), words, k, B,
    )
    if err != 0:
        raise RuntimeError(f"serve kernel launch failed: cudaError {err}")
    launches += 1
    return table, resps, seq_out
