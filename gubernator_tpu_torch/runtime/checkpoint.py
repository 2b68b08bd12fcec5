"""Table checkpoints: bulk persistence of the slot table as numpy files.

The Store/Loader SPI (runtime/store.py) persists CacheItems one at a time,
which round-trips every row through host Python.  For a large table the
natural path is to checkpoint the columns themselves: the table's twelve
columns (plus the fingerprint->key map when key strings must survive, the
sketch tier's counters and the cold tier's rows) go to one directory per
step, one `.npy` file per column and JSON beside them.  This is the JAX
package's orbax checkpointer (runtime/checkpoint.py) without orbax: no
dependency beyond numpy, and the same two features the reference leaves to
implementors (store.go:69-78, README.md:165-181):
- fast restart warm-up: restore the whole table before serving;
- periodic snapshots: a background loop checkpointing every N seconds
  (crash recovery with bounded staleness, the acceptable-loss contract of
  architecture.md:5-11).

A step is written to a temporary directory beside its final name and
renamed into place only when every file is on disk, so a crash mid-save
leaves the previous complete step and a `step_N.tmp-*` directory that
`_complete_steps` ignores.  The copy to the host holds the backend lock
only while the column copies are queued on the backend's stream
(TorchBackend.snapshot); `last_save` records how long that was.

`CheckpointLoader` plugs the checkpointer into the standard Loader slot of
Config for code written against the SPI.
"""
from __future__ import annotations

import asyncio
import json
import logging
import os
import shutil
import time
import uuid
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from gubernator_tpu_torch.core.types import CacheItem
from gubernator_tpu_torch.ops.state import SlotTable
from gubernator_tpu_torch.runtime.store import Loader

log = logging.getLogger("gubernator_tpu_torch.checkpoint")

_SKETCH_FIELDS = ("cur", "prev", "window_start", "window_ms")


def _write_arrays(path: str, arrays: Dict[str, np.ndarray]) -> int:
    """One .npy per array under `path`; returns the bytes written."""
    os.makedirs(path)
    n = 0
    for f, a in arrays.items():
        a = np.ascontiguousarray(a)
        np.save(os.path.join(path, f + ".npy"), a, allow_pickle=False)
        n += a.nbytes
    return n


def _read_arrays(path: str, fields) -> Dict[str, np.ndarray]:
    return {
        f: np.load(os.path.join(path, f + ".npy"), allow_pickle=False)
        for f in fields
    }


class TableCheckpointer:
    """Save and restore a TorchBackend's slot table (and the sketch's and
    cold tier's state) under `directory`, one `step_<N>` directory each."""

    def __init__(self, directory: str) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        # {"step", "bytes", "seconds", "lock_s"} of the last save.
        self.last_save: Dict[str, float] = {}

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    def _complete_steps(self) -> List[int]:
        """Steps with a fully written checkpoint.  Temporary directories
        from a crash mid-save (`step_N.tmp-...`) and any other
        non-integer suffixes are ignored, not fatal."""
        steps = []
        for d in os.listdir(self.directory):
            if not d.startswith("step_"):
                continue
            suffix = d[len("step_"):]
            if suffix.isdigit():
                steps.append(int(suffix))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self._complete_steps()
        return steps[-1] if steps else None

    def save(
        self,
        backend,
        step: int,
        keep: int = 3,
        sketch=None,  # SketchBackend: include the CMS state
        coldtier=None,  # ColdTier: include the demoted rows
    ) -> str:
        """Checkpoint the table (and the keymap when tracked, the sketch
        tier's counters when passed, the cold tier's resident rows when
        passed); prunes old steps beyond `keep`."""
        t0 = time.monotonic()
        table = backend.snapshot()
        lock_s = backend.last_copy_lock_s
        keymap = None
        if backend._keymap is not None:
            with backend._keymap_lock:
                keymap = dict(backend._keymap)
        sk = None
        if sketch is not None:
            with sketch._lock:
                st = sketch.state
                sk = {f: getattr(st, f).to("cpu", copy=True).numpy()
                      for f in _SKETCH_FIELDS}
        cold = dict(coldtier.snapshot()) if coldtier is not None else None

        path = self._step_dir(step)
        tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp)
        try:
            nbytes = _write_arrays(os.path.join(tmp, "table"), table)
            if sk is not None:
                nbytes += _write_arrays(os.path.join(tmp, "sketch"), sk)
            if cold is not None:
                nbytes += _write_arrays(os.path.join(tmp, "coldtier"), cold)
            if keymap is not None:
                with open(os.path.join(tmp, "keymap.json"), "w") as f:
                    json.dump({str(k): v for k, v in keymap.items()}, f)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({
                    "num_slots": int(table["key"].shape[0]),
                    "coldtier_fields": sorted(cold) if cold else [],
                }, f)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune(keep)
        self.last_save = {
            "step": step, "bytes": nbytes,
            "seconds": time.monotonic() - t0, "lock_s": lock_s,
        }
        log.info("checkpointed table to %s", path)
        return path

    def restore(self, backend, step: Optional[int] = None,
                sketch=None, coldtier=None) -> int:
        """Restore the table in place; returns the restored step.
        `_install_table` refuses a checkpoint of another slot count.  With
        `sketch`, restores the CMS state too when the checkpoint has it
        and its geometry matches (the CURRENT config owns window_ms; the
        host window mirror follows the restored window_start).  With
        `coldtier`, the demoted rows are re-inserted (capacity may differ;
        overflow rows are dropped and counted)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}"
                )
        path = self._step_dir(step)
        backend._install_table(
            _read_arrays(os.path.join(path, "table"), SlotTable._fields))
        sk_path = os.path.join(path, "sketch")
        if sketch is not None and os.path.isdir(sk_path):
            sk = _read_arrays(sk_path, _SKETCH_FIELDS)
            if sk["cur"].shape != (sketch.cfg.depth, sketch.cfg.width):
                # A resized sketch hashes keys to other cells: the old
                # counts mean nothing under the new geometry.
                log.warning(
                    "checkpointed sketch geometry %s != configured "
                    "(%d, %d); skipping sketch restore",
                    sk["cur"].shape, sketch.cfg.depth, sketch.cfg.width,
                )
            else:
                dev = sketch.device
                win_start = sk["window_start"].item()
                with sketch._lock:
                    sketch.state = type(sketch.state)(
                        cur=torch.from_numpy(sk["cur"]).to(dev),
                        prev=torch.from_numpy(sk["prev"]).to(dev),
                        window_start=torch.tensor(
                            win_start, dtype=torch.int64, device=dev),
                        window_ms=torch.tensor(
                            int(sketch.cfg.window_ms), dtype=torch.int64,
                            device=dev),
                    )
                    sketch._win_start = win_start
        cold_path = os.path.join(path, "coldtier")
        if coldtier is not None and os.path.isdir(cold_path):
            with open(os.path.join(path, "meta.json")) as f:
                fields = json.load(f)["coldtier_fields"]
            n = coldtier.restore(_read_arrays(cold_path, fields))
            log.info("restored %d cold-tier rows", n)
        km_path = os.path.join(path, "keymap.json")
        if os.path.exists(km_path) and backend._keymap is not None:
            with open(km_path) as f:
                km = {int(k): v for k, v in json.load(f).items()}
            with backend._keymap_lock:
                backend._keymap.update(km)
        log.info("restored table from %s", path)
        return step

    def _prune(self, keep: int) -> None:
        """Drop all but the newest `keep` checkpoints (keep <= 0 keeps
        only the newest one, the snapshot just written)."""
        steps = self._complete_steps()
        cut = max(keep, 1)
        for s in steps[:-cut]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


class PeriodicCheckpointLoop:
    """Background snapshot loop (bounded-staleness crash recovery)."""

    def __init__(
        self,
        backend,
        directory: str,
        interval_s: float = 30.0,
        keep: int = 3,
        sketch=None,  # SketchBackend: snapshot the CMS state too
        coldtier=None,  # ColdTier: snapshot the demoted rows too
    ) -> None:
        self.ckptr = TableCheckpointer(directory)
        self.backend = backend
        self.sketch = sketch
        self.coldtier = coldtier
        self.interval_s = interval_s
        self.keep = keep
        self._task: Optional[asyncio.Task] = None
        self._step = (self.ckptr.latest_step() or 0) + 1

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def stop(self, final_save: bool = True) -> None:
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None
        if final_save:
            await self._save_once()

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            await self._save_once()

    async def _save_once(self) -> None:
        loop = asyncio.get_running_loop()
        step = self._step
        self._step += 1
        try:
            await loop.run_in_executor(
                None,
                lambda: self.ckptr.save(
                    self.backend, step, self.keep, sketch=self.sketch,
                    coldtier=self.coldtier,
                ),
            )
        except Exception as e:  # noqa: BLE001
            log.error("periodic checkpoint failed: %s", e)


class CheckpointLoader(Loader):
    """Loader SPI adapter over TableCheckpointer (the JAX package's
    OrbaxLoader).

    `load()` yields nothing itself: restore happens at table granularity
    via `attach()`; `save()` likewise checkpoints the whole table."""

    def __init__(self, directory: str) -> None:
        self.ckptr = TableCheckpointer(directory)
        self._backend = None
        self._sketch = None
        self._coldtier = None

    def attach(self, backend, sketch=None, coldtier=None) -> None:
        self._backend = backend
        self._sketch = sketch
        self._coldtier = coldtier
        try:
            self.ckptr.restore(backend, sketch=sketch, coldtier=coldtier)
        except FileNotFoundError:
            pass

    def load(self) -> Iterable[CacheItem]:
        return []

    def save(self, items: Iterator[CacheItem]) -> None:
        if self._backend is not None:
            step = (self.ckptr.latest_step() or 0) + 1
            self.ckptr.save(self._backend, step, sketch=self._sketch,
                            coldtier=self._coldtier)
