"""Build a CUDA source of this package into a shared library and load it.

Each kernel is a `csrc/*.cu` file with a plain C interface.  At first use it
is compiled by nvcc for Hopper (sm_90a) into `gubernator_tpu_torch/_build/`
(listed in .gitignore), under a name keyed by a hash of the source and the
flags, and loaded with ctypes.  Nothing is compiled when a module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time; 0.0 when the library was already built
    log: str        # nvcc/ptxas output of the compile


_loaded: Dict[str, Built] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")


def build(name: str) -> Built:
    """Compile (if needed) and load `csrc/<name>.cu`."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
        cmd: List[str] = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
        os.replace(tmp, out)
    built = Built(ctypes.CDLL(str(out)), out, seconds, log)
    _loaded[name] = built
    return built
