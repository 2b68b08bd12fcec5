"""The open-loop dispatch engine + phase-linked attribution
(docs/loadgen.md).

Open loop means the arrival schedule is the clock: each request is
dispatched at its precomputed intended-send time as a free-running
asyncio task, and its latency is recorded from the INTENDED send time
— never from when the event loop actually got around to sending it.
A slow response therefore delays nothing and hides nothing: if the
server stalls 200ms, every arrival scheduled inside the stall records
its full queueing delay, which is exactly the signal a closed-loop
driver destroys (it would sit waiting on one response, silently not
sending — coordinated omission).  ``closed_loop`` is the honest
comparator: tests/test_loadgen.py pins the divergence with an induced
stall.

The engine also records intended-vs-actual send skew into a second
recorder: skew tells you when the *generator* fell behind (an
overloaded client machine flatters tails in a different way), so the
artifact row can prove the load was actually delivered on plan.
"""
from __future__ import annotations

import asyncio
import collections
import os
import time
from typing import Awaitable, Callable, Dict, List, Optional, Sequence

from ..runtime import tracing
from ..runtime.metrics import HdrRecorder

# send(key_idx) -> True (admitted) | False (denied) ; raises on error.
SendFn = Callable[[int], Awaitable[bool]]


class OutcomeCounts:
    """Client-observed outcome tally for one phase (the verdict's
    client side of the ledger cross-check)."""

    def __init__(self) -> None:
        self.admitted = 0
        self.denied = 0
        self.errors = 0
        self.per_key_admitted: Dict[int, int] = {}
        # What the failed sends said (the error's text, cut to 200
        # characters) and how often: the port's own, for a verdict to show.
        self.error_kinds: collections.Counter = collections.Counter()

    def merge(self, other: "OutcomeCounts") -> "OutcomeCounts":
        self.admitted += other.admitted
        self.denied += other.denied
        self.errors += other.errors
        self.error_kinds.update(other.error_kinds)
        for k, n in other.per_key_admitted.items():
            self.per_key_admitted[k] = (
                self.per_key_admitted.get(k, 0) + n
            )
        return self


async def open_loop(
    send: SendFn,
    schedule,
    latency: HdrRecorder,
    skew: HdrRecorder,
    counts: Optional[OutcomeCounts] = None,
) -> OutcomeCounts:
    """Dispatch `schedule` open-loop: every arrival fires at its
    intended time regardless of outstanding responses; latency is
    recorded from intended-send, send skew (actual - intended) is
    recorded separately.  Returns the outcome tally."""
    out = counts if counts is not None else OutcomeCounts()
    loop = asyncio.get_running_loop()
    start = loop.time()
    tasks: List[asyncio.Task] = []

    async def one(intended: float, key_idx: int) -> None:
        actual = loop.time()
        skew.record(max(0.0, actual - intended))
        try:
            admitted = await send(int(key_idx))
        except Exception as e:  # noqa: BLE001 — counted, with its text
            out.errors += 1
            out.error_kinds[str(e)[:200]] += 1
        else:
            if admitted:
                out.admitted += 1
                out.per_key_admitted[int(key_idx)] = (
                    out.per_key_admitted.get(int(key_idx), 0) + 1
                )
            else:
                out.denied += 1
        # From INTENDED send: queueing delay the server imposed on this
        # arrival is part of its latency, even if the generator itself
        # dispatched late (that lateness is separately in `skew`).
        latency.record(loop.time() - intended)

    for t_off, key_idx in zip(schedule.times_s, schedule.key_idx):
        intended = start + float(t_off)
        delay = intended - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.ensure_future(one(intended, key_idx)))
    if tasks:
        await asyncio.gather(*tasks)
    return out


async def closed_loop(
    send: SendFn,
    schedule,
    latency: HdrRecorder,
    counts: Optional[OutcomeCounts] = None,
) -> OutcomeCounts:
    """The coordinated-omission-prone comparator: one request in
    flight, next send waits for the previous response, latency from the
    ACTUAL send.  Kept only so the divergence is demonstrable
    (tests/test_loadgen.py) — never used for reported numbers."""
    out = counts if counts is not None else OutcomeCounts()
    loop = asyncio.get_running_loop()
    start = loop.time()
    for t_off, key_idx in zip(schedule.times_s, schedule.key_idx):
        delay = start + float(t_off) - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        t0 = loop.time()
        try:
            admitted = await send(int(key_idx))
        except Exception as e:  # noqa: BLE001 — counted, with its text
            out.errors += 1
            out.error_kinds[str(e)[:200]] += 1
        else:
            if admitted:
                out.admitted += 1
            else:
                out.denied += 1
        latency.record(loop.time() - t0)
    return out


class PhaseTracker:
    """Phase-linked attribution: one object per scenario run that
    propagates phase boundaries into every observability plane —
    flightrec ring records (kind="load_phase"), the daemon's
    /debug/vars `load` block (gubtop's per-node load line), the
    gubernator_load_active gauge, a gubscope span per phase, and an
    optional time-boxed torch.profiler capture.

    `daemons` is the in-process daemon list (empty when driving an
    external cluster — span attribution still applies, daemon-side
    markers are then the daemons' own business).
    """

    def __init__(
        self,
        scenario: str,
        daemons: Sequence = (),
        profile_dir: Optional[str] = None,
        profile_box_s: float = 2.0,
    ) -> None:
        self.scenario = scenario
        self.daemons = list(daemons)
        self.profile_dir = profile_dir
        self.profile_box_s = profile_box_s
        self._seq = 0
        self._span = None
        self._phase: Optional[str] = None
        self._profiling = False
        self._profile_stop_handle = None
        self._prof = None
        self._trace_path = ""

    # -- lifecycle -----------------------------------------------------

    def enter(self, phase: str, profile: bool = False) -> None:
        self.exit()
        self._phase = phase
        self._seq += 1
        for d in self.daemons:
            fr = getattr(d, "flightrec", None)
            if fr is not None:
                fr.record(
                    "load_phase", scenario=self.scenario, phase=phase,
                    seq=self._seq, action="enter",
                )
            d.load_status = {
                "scenario": self.scenario,
                "phase": phase,
                "seq": self._seq,
                "since": time.time(),
            }
            m = getattr(d, "metrics", None)
            if m is not None:
                m.load_active.labels(
                    scenario=self.scenario, phase=phase
                ).set(1)
        if tracing.enabled():
            self._span = tracing.start_span(
                "load.phase", tracing.current_context(),
            )
            if self._span is not None:
                self._span.set_attribute("load.scenario", self.scenario)
                self._span.set_attribute("load.phase", phase)
                self._span.set_attribute("load.seq", self._seq)
        if profile and self.profile_dir:
            self._start_profiler(phase)

    def exit(self) -> None:
        if self._phase is None:
            return
        phase, self._phase = self._phase, None
        self._stop_profiler()
        for d in self.daemons:
            fr = getattr(d, "flightrec", None)
            if fr is not None:
                fr.record(
                    "load_phase", scenario=self.scenario, phase=phase,
                    seq=self._seq, action="exit",
                )
            d.load_status = None
            m = getattr(d, "metrics", None)
            if m is not None:
                try:
                    m.load_active.remove(self.scenario, phase)
                except KeyError:
                    pass
        if self._span is not None:
            self._span.end()
            self._span = None

    # -- optional time-boxed device profiling --------------------------

    def _start_profiler(self, phase: str) -> None:
        """Best-effort torch.profiler capture at a phase boundary, boxed
        to `profile_box_s` so a long phase can't fill the disk (the
        same discipline as flightrec's breach capture); stopping it
        exports a Chrome trace, `trace.json` in the phase's directory."""
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            out = os.path.join(
                self.profile_dir, f"{self.scenario}-{phase}"
            )
            os.makedirs(out, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
            self._prof = prof
            self._trace_path = os.path.join(out, "trace.json")
            self._profiling = True
            try:
                loop = asyncio.get_running_loop()
                self._profile_stop_handle = loop.call_later(
                    self.profile_box_s, self._stop_profiler
                )
            except RuntimeError:
                pass  # no loop: stopped at phase exit
        except Exception:
            self._profiling = False

    def _stop_profiler(self) -> None:
        if self._profile_stop_handle is not None:
            self._profile_stop_handle.cancel()
            self._profile_stop_handle = None
        if not self._profiling:
            return
        self._profiling = False
        prof, self._prof = self._prof, None
        try:
            prof.stop()
            prof.export_chrome_trace(self._trace_path)
        except Exception:
            pass
