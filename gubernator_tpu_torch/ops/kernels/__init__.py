"""Hand-written CUDA kernels: their ctypes wrappers, launch counts and the
nvcc build (build.py)."""
from __future__ import annotations

import torch


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` and `shape` on
    `device` (what a kernel's raw pointer needs)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def device_index(dev: torch.device) -> int:
    """The CUDA ordinal of `dev` (the current device when it names none)."""
    return dev.index if dev.index is not None else torch.cuda.current_device()


def resolve_device(device, who: str = "mesh") -> torch.device:
    """`device` as a torch.device with its index filled in; raises on a
    CUDA device without a card (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device; pass DeviceConfig(platform='cpu') to "
            "run on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
