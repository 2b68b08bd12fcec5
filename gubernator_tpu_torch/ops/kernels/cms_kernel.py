"""K2, the count-min-sketch merge kernel: its wrapper and launch count.

    state, packed[k, 2, B] = cms_multi_step(
        state, kh[k, B], hits[k, B], lim[k, B], now)

Replaces the Pallas kernel of gubernator_tpu/ops/pallas/cms_kernel.py
(`_cms_kernel`, `cms_step_pallas_impl`): one dispatch applies the k chunks
of a merge in order, each seeing the previous chunk's adds.  It is two
launches on the caller's stream: a sweep of the tables that only a merge
that rolls the window does, and one cluster of blocks that walks the chunks
with cluster barriers, no grid barrier (csrc/cms_kernel.cu says how).  The
contract is the JAX package's `make_multi_step`
(runtime/sketch_backend.py); `packed[:, 0]` is over and `packed[:, 1]` the
estimate.  Its plain version is ops/sketch.py `multi_step`.

On the card the sketch is updated IN PLACE (cur, prev and window_start) and
the same state is returned; the plain version returns new tensors.

Tensors on the CPU take the plain `multi_step`.  Tensors on a CUDA device
launch the kernel, or raise: there is no fallback.  `launches` counts one
per merge dispatched to the kernel (its two launches together, whether or
not the merge rolls), and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gubernator_tpu_torch.ops.kernels import check_tensor, device_index
from gubernator_tpu_torch.ops.sketch import SketchState, multi_step

launches = 0

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (at first use) and bind csrc/cms_kernel.cu."""
    global _lib
    if _lib is None:
        from gubernator_tpu_torch.ops.kernels.build import build

        lib = build("cms_kernel").lib
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gub_cms_launch.argtypes = [
            i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32,
        ]
        lib.gub_cms_launch.restype = i32
        lib.gub_cms_cluster.argtypes = [i32]
        lib.gub_cms_cluster.restype = i32
        _lib = lib
    return _lib


def cluster_blocks(dev) -> int:
    """Blocks (one per SM) in the cluster that walks a merge's chunks of at
    most 1024 lanes on CUDA device `dev`: 16, or 8 where the card refuses
    16."""
    n = library().gub_cms_cluster(device_index(torch.device(dev)))
    if n <= 0:
        raise RuntimeError(f"sketch kernel cluster: cudaError {-n}")
    return n


def cms_multi_step(
    state: SketchState,
    kh: torch.Tensor,
    hits: torch.Tensor,
    lim: torch.Tensor,
    now: int,
) -> Tuple[SketchState, torch.Tensor]:
    """Apply a merge of k chunks; returns (state, int32[k, 2, B])."""
    global launches
    dev = state.cur.device
    if state.cur.dim() != 2:
        raise ValueError(f"cur: shape {tuple(state.cur.shape)}, expected [D, W]")
    D, W = state.cur.shape
    if kh.dim() != 2:
        raise ValueError(f"kh: shape {tuple(kh.shape)}, expected [k, B]")
    k, B = kh.shape
    check_tensor("cur", state.cur, torch.int32, (D, W), dev)
    check_tensor("prev", state.prev, torch.int32, (D, W), dev)
    check_tensor("window_start", state.window_start, torch.int64, (), dev)
    check_tensor("window_ms", state.window_ms, torch.int64, (), dev)
    check_tensor("kh", kh, torch.int64, (k, B), dev)
    check_tensor("hits", hits, torch.int32, (k, B), dev)
    check_tensor("lim", lim, torch.int32, (k, B), dev)
    if not 1 <= D <= 8 or W <= 0 or W & (W - 1):
        raise ValueError(f"sketch [{D}, {W}]: depth must be 1..8 and width "
                         "a power of two")
    now = int(now)
    if dev.type == "cpu":
        return multi_step(state, kh, hits, lim, now)
    if dev.type != "cuda":
        raise ValueError(f"no sketch kernel for device {dev}")
    if W > 2**30 or B > 2**31 - 1:
        raise ValueError("width must be at most 2^30 and B fit int32")

    packed = torch.empty((k, 2, B), dtype=torch.int32, device=dev)
    if k == 0:  # no chunk: no roll either, as in the JAX scan
        return state, packed
    lib = library()
    err = lib.gub_cms_launch(
        device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
        state.cur.data_ptr(), state.prev.data_ptr(),
        state.window_start.data_ptr(), state.window_ms.data_ptr(),
        kh.data_ptr(), hits.data_ptr(), lim.data_ptr(), packed.data_ptr(),
        now, D, W.bit_length() - 1, k, B,
    )
    if err != 0:
        raise RuntimeError(f"sketch kernel launch failed: cudaError {err}")
    launches += 1
    return state, packed
