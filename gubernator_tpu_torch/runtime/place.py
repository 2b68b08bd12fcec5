"""The port's device boundary: a device and the stream its work goes on.

Every crossing of the engines goes through here: host to card (`upload`,
`upload_cols`), card to host (`fetch`, `PendingFetch`) and card to card
(`carry`), and so does the choice between the card and the CPU.  A
`DevicePlace` is one device and one stream (None on the CPU), with K1's
lane-list scratch reused in that stream's order.  A TorchBackend has one
(runtime/backend.py), a MeshBackend one a shard (parallel/sharded.py), and
a SketchBackend one (runtime/sketch_backend.py).

On the card, uploads go through pinned host memory with non-blocking
copies, and a fetch copies into pinned memory behind an event recorded
right after the copies, so a fetch waits for its own dispatch only, never
for launches queued after it.  On the CPU the host arrays are the tensors
themselves and nothing waits.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch.ops.kernels import resolve_device, serve_kernel


class PendingFetch:
    """Device tensors on their way to the host: copies queued on one
    place's stream or several, one event at the end of each, and a finish
    step that gives the host arrays.  `synchronize()` waits on those
    events alone (none on the CPU); `wait()` also finishes."""

    __slots__ = ("_events", "_finish")

    def __init__(self, events: Sequence["torch.cuda.Event"],
                 finish: Callable[[], List[np.ndarray]]) -> None:
        self._events, self._finish = list(events), finish

    @classmethod
    def join(cls, fetches: Sequence["PendingFetch"],
             finish: Callable[[], List[np.ndarray]]) -> "PendingFetch":
        """One fetch of several places' fetches, finished by `finish`."""
        return cls([ev for f in fetches for ev in f._events], finish)

    def synchronize(self) -> None:
        """Wait until the copies are done, without the finish step."""
        for ev in self._events:
            ev.synchronize()
        self._events = []

    def wait(self) -> List[np.ndarray]:
        self.synchronize()
        return self._finish()


class DevicePlace:
    """A device and the stream its work goes on (None on the CPU), with
    K1's lane-list scratch, reused in that stream's order: the per-device
    plumbing of one table or sketch."""

    __slots__ = ("device", "stream", "_scratch")

    def __init__(self, device: torch.device,
                 stream: Optional["torch.cuda.Stream"] = None) -> None:
        self.device = device
        self.stream = stream
        self._scratch: Optional[torch.Tensor] = None

    @classmethod
    def resolve(cls, device, who: str,
                stream: Optional["torch.cuda.Stream"] = None
                ) -> "DevicePlace":
        """`device` ("cuda" when None) with its index filled in, and on a
        card `stream` or the card's current stream.  Raises on a CUDA
        device without a card (there is no fallback to the CPU)."""
        dev = resolve_device(device or "cuda", who)
        if dev.type != "cuda":
            return cls(dev)
        return cls(dev, stream if stream is not None
                   else torch.cuda.current_stream(dev))

    @classmethod
    def fresh(cls, device: torch.device) -> "DevicePlace":
        """`device` with a new stream of its own on a card (a mesh
        shard's)."""
        return cls(device, torch.cuda.Stream(device)
                   if device.type == "cuda" else None)

    def on_stream(self):
        """Run the caller's device work on this place's stream (which
        also makes its card the current device)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def synchronize(self) -> None:
        """Wait for the work queued on this place's stream."""
        if self.stream is not None:
            self.stream.synchronize()

    # -- host to card ----------------------------------------------------
    def upload(self, a) -> torch.Tensor:
        """Host array -> device tensor: numpy is copied once into pinned
        memory (a strided view, such as one shard's part of a block,
        included) and sent with a non-blocking copy on this place's stream
        (call it inside `on_stream`)."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        a = np.asarray(a)
        if self.stream is None:
            return torch.from_numpy(np.ascontiguousarray(a)).reshape(a.shape)
        dtype = torch.from_numpy(np.empty(0, dtype=a.dtype)).dtype
        pinned = torch.empty(a.shape, dtype=dtype, pin_memory=True)
        pinned.numpy()[...] = a
        return pinned.to(self.device, non_blocking=True)

    def upload_cols(self, parts: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """Host arrays of one shape (int64, int32 or float64) -> tensors of
        their dtypes here, in one pinned copy: they travel as the rows of
        one int64 array (int32 widened, float64 as its bits) and are split
        and narrowed back on the device (call it inside `on_stream`)."""
        packed = np.empty((len(parts),) + np.shape(parts[0]), dtype=np.int64)
        for i, a in enumerate(parts):
            packed[i] = a.view(np.int64) if a.dtype == np.float64 else a
        dev = self.upload(packed)
        return [
            dev[i].view(torch.float64) if a.dtype == np.float64
            else dev[i].to(torch.int32) if a.dtype == np.int32 else dev[i]
            for i, a in enumerate(parts)
        ]

    # -- card to host ----------------------------------------------------
    def host_buffer(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """An empty host tensor to fetch into: pinned on a card."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.stream is not None)

    def fetch(self, tensors: Sequence[torch.Tensor],
              host: Optional[Sequence[torch.Tensor]] = None) -> PendingFetch:
        """Start copying `tensors` to the host on this place's stream,
        right behind the work queued on it (call it inside `on_stream`),
        and record one event after the copies.  `host`: buffers to copy
        into (`host_buffer`), made before a lock is taken so that the lock
        is held only while the copies are queued.  Without them a card
        copies into fresh pinned buffers and the CPU keeps `tensors`
        themselves, which is right only for fresh tensors (a dispatch's
        outputs), never for live table columns."""
        card = self.stream is not None
        if host is not None:
            host = list(host)
            for h, t in zip(host, tensors):
                h.copy_(t, non_blocking=card)
        elif not card:
            host = list(tensors)
        else:
            host = []
            for t in tensors:
                h = self.host_buffer(t.shape, t.dtype)
                h.copy_(t, non_blocking=True)
                host.append(h)
        events = []
        if card:
            ev = torch.cuda.Event()
            ev.record(self.stream)
            events.append(ev)
        return PendingFetch(events, lambda: [h.numpy() for h in host])

    # -- K1's card-only resources ----------------------------------------
    def scratch_for(self, k: int, B: int) -> Optional[torch.Tensor]:
        """K1's scratch for a dispatch of k rounds of B lanes (None on the
        CPU, whose plain kernel needs none, and for no rounds).  Grows the
        kept buffer when a larger dispatch needs it.  The buffer returned
        is the one checked or made here, so two threads that dispatch on
        different tables of this place (a mesh shard's auth table and its
        engine's cache) each get one large enough; launches on the one
        stream use it in turn."""
        if self.stream is None or not k:
            return None
        words = serve_kernel.scratch_words(self.device, k, B)
        buf = self._scratch
        if buf is None or buf.numel() < words:
            self._scratch = buf = None
            try:
                buf = torch.empty(
                    max(words, 1), dtype=torch.int32, device=self.device)
            except torch.OutOfMemoryError as e:
                raise ValueError(
                    f"K1 scratch for {k} rounds of {B} lanes needs "
                    f"{4 * words} bytes on {self.device}; lower "
                    "GUBER_RING_SLOTS x GUBER_RING_ROUNDS or the batch "
                    "size"
                ) from e
            self._scratch = buf
        return buf

    def claim_words(self, num_slots: int) -> Optional[torch.Tensor]:
        """K1's claim words for a table of `num_slots` here, all INT32_MAX
        between launches (None on the CPU)."""
        if self.stream is None:
            return None
        with self.on_stream():
            return serve_kernel.new_claim_buffer(num_slots, self.device)


def carry(t: torch.Tensor, src: DevicePlace, dst: DevicePlace) -> torch.Tensor:
    """`t`, made on `src`'s stream, for use on `dst`'s: ordered after the
    work on src that made it and before dst's work queued later.

    On one card nothing is copied: dst's stream waits on src's, and `t` is
    marked in use on dst's stream, so the allocator keeps it until that
    work is done.  Between cards PyTorch runs the copy on the SOURCE card's
    current stream with a two-way barrier against the destination card's
    current stream, so both are made current here: the copy follows src's
    work and dst's later work follows the copy."""
    if dst.stream is None:
        return t.to(dst.device)
    if src.device == dst.device:
        if src.stream != dst.stream:
            dst.stream.wait_stream(src.stream)
            t.record_stream(dst.stream)
        return t
    with src.on_stream(), dst.on_stream():
        return t.to(dst.device, non_blocking=True)
