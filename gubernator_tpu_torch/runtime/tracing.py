"""Gubscope: end-to-end request attribution through the serving pipeline.

The reference wraps nearly every function in holster/OTel scopes
(gubernator.go:118-121, workers.go:250-253, algorithms.go:32-35) and
exports to Jaeger/OTLP via standard env vars (jaegertracing.md).  This
runtime's request path is a deep async pipeline — coalesced merges,
dispatch/fetch stages, ring slots, a runner thread, FIFO host jobs, peer
forwards — so a span plane that only knows the RPC boundary cannot
answer "where did the 300ms go".  This module is the attribution core:

  * **Spans** are lightweight in-process records (trace/span ids,
    parent, attributes, links, wall times) — no OpenTelemetry package is
    required to create, propagate, or assert on them.  When the OTel SDK
    and OTLP exporter packages ARE installed (the `[tracing]` extra) and
    `OTEL_EXPORTER_OTLP_ENDPOINT` is set, finished spans are bridged to
    OTLP; otherwise they stay in-process (a bounded recent-span ring
    that the flight recorder attaches to breach dumps).
  * **Context** rides a contextvar on the event loop and is carried
    EXPLICITLY across every thread hand-off (coalescer entries, ring
    jobs) — contextvars do not cross `run_in_executor`, so each async
    seam stores the submitting context and re-binds it on the worker
    (`wrap` / `use_context`).
  * **Cross-peer**: `grpc_metadata()` renders the current context as a
    w3c `traceparent` header for outbound peer RPCs;
    `parse_traceparent()` is the server-side extract (daemon.py's
    tracing interceptor), so one trace spans a multi-daemon cluster.
  * **Sampling** follows the OTel env spec (`OTEL_TRACES_SAMPLER` /
    `OTEL_TRACES_SAMPLER_ARG`): parent-based by construction (a child
    inherits its parent's decision), with the root decision drawn from
    the configured ratio.  `always_off`/`off` disables tracing outright.

Disabled is the default and costs (almost) nothing: every entry point
checks one module global and returns before allocating anything — the
hot path creates zero spans and zero contexts until `init_tracing()`
arms the plane (tests/test_tracing.py pins this).

`device_step_annotation` additionally marks device steps with
`torch.profiler.record_function` (an NVTX range too, under a profiler
that emits them) so host spans line up with device kernels in profiler
traces; the ring runner (runtime/ring.py) uses it.  The engines' stages
(`stage_begin` / `stage_end`) are the program's own records on the
profiler's clock, kept off its device timeline.
"""
from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

log = logging.getLogger("gubernator_tpu_torch.tracing")

# Bounded ring of recently finished (sampled) spans: the in-process
# trace tail the flight recorder attaches to breach dumps.  Fixed cap —
# a span record is small and 512 covers several breach windows.
RECENT_SPAN_CAP = 512

_SAMPLER_ALIASES = {
    "on": "always_on",
    "off": "always_off",
    "parentbased_always_on": "always_on",
    "parentbased_always_off": "always_off_root",
    "parentbased_traceidratio": "traceidratio",
}


class SpanContext:
    """Immutable (trace_id, span_id, sampled) triple — what crosses
    every async seam and the wire (w3c traceparent)."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: int, span_id: int, sampled: bool) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def traceparent(self) -> str:
        return "00-%032x-%016x-%s" % (
            self.trace_id, self.span_id, "01" if self.sampled else "00"
        )

    def trace_id_hex(self) -> str:
        return "%032x" % self.trace_id

    def span_id_hex(self) -> str:
        return "%016x" % self.span_id

    def __repr__(self) -> str:  # debugging/test output
        return f"<SpanContext {self.traceparent()}>"


def parse_traceparent(value: str) -> Optional[SpanContext]:
    """Parse a w3c `traceparent` header; None on anything malformed
    (never raises — this runs on untrusted RPC metadata)."""
    try:
        parts = value.strip().split("-")
        if len(parts) != 4:
            return None
        version, tid, sid, flags = parts
        if len(version) != 2 or len(tid) != 32 or len(sid) != 16:
            return None
        if int(version, 16) < 0 or version == "ff":
            return None
        trace_id = int(tid, 16)
        span_id = int(sid, 16)
        if trace_id == 0 or span_id == 0:
            return None
        sampled = bool(int(flags, 16) & 0x01)
        return SpanContext(trace_id, span_id, sampled)
    except (ValueError, AttributeError):
        return None


class Span:
    """One finished-or-in-flight sampled span.  Mutation (attributes,
    links) is single-writer by construction: the thread running the
    spanned section.  `end()` is idempotent and hands the span to the
    exporters."""

    __slots__ = (
        "name", "context", "parent_id", "start_ns", "end_ns",
        "attributes", "links", "error",
    )

    def __init__(
        self,
        name: str,
        context: SpanContext,
        parent_id: Optional[int],
        attributes: Optional[Dict] = None,
        links: Sequence[SpanContext] = (),
    ) -> None:
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.start_ns = time.time_ns()
        self.end_ns: Optional[int] = None
        self.attributes: Dict = dict(attributes) if attributes else {}
        self.links: List[SpanContext] = [
            l for l in links if l is not None
        ]
        self.error: Optional[str] = None

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def duration_ms(self) -> float:
        end = self.end_ns if self.end_ns is not None else time.time_ns()
        return (end - self.start_ns) / 1e6

    def end(self, error: Optional[str] = None) -> None:
        if self.end_ns is not None:
            return
        self.end_ns = time.time_ns()
        if error is not None:
            self.error = error
        st = _state
        if st is not None:
            st.finish(self)

    def to_dict(self) -> Dict:
        """JSON-friendly form (breach dumps, smoke artifacts)."""
        return {
            "name": self.name,
            "trace_id": self.context.trace_id_hex(),
            "span_id": self.context.span_id_hex(),
            "parent_id": (
                "%016x" % self.parent_id
                if self.parent_id is not None else None
            ),
            "start_ns": self.start_ns,
            "duration_ms": round(self.duration_ms(), 3),
            "attributes": dict(self.attributes),
            "links": [
                {"trace_id": l.trace_id_hex(), "span_id": l.span_id_hex()}
                for l in self.links
            ],
            "error": self.error,
        }


class TracingStatus:
    """What `init_tracing` actually armed — the honest exporter status
    the old bool return hid (a set OTLP endpoint with the exporter
    packages missing used to report success while spans went nowhere).
    Truthy iff tracing is active, for old-style callers."""

    __slots__ = (
        "enabled", "service_name", "sampler", "ratio",
        "exporter", "exporter_error", "reason",
    )

    def __init__(self, enabled, service_name="", sampler="", ratio=1.0,
                 exporter="none", exporter_error=None, reason=""):
        self.enabled = enabled
        self.service_name = service_name
        self.sampler = sampler
        self.ratio = ratio
        # "otlp" | "memory" | "none" | an explicit exporter's class name
        self.exporter = exporter
        self.exporter_error = exporter_error
        self.reason = reason

    def __bool__(self) -> bool:
        return self.enabled

    def as_dict(self) -> Dict:
        return {
            "enabled": self.enabled,
            "service": self.service_name,
            "sampler": self.sampler,
            "ratio": self.ratio,
            "exporter": self.exporter,
            "exporter_error": self.exporter_error,
            "reason": self.reason,
        }


class _OTLPBridge:
    """Adapter from this module's spans to the OTel SDK's OTLP/HTTP
    exporter (the `[tracing]` extra).  Construction raises ImportError
    when the packages are absent — init_tracing reports that instead of
    pretending spans export."""

    def __init__(self, service_name: str) -> None:
        from opentelemetry import trace as otel_trace
        from opentelemetry.exporter.otlp.proto.http.trace_exporter import (
            OTLPSpanExporter,
        )
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import ReadableSpan
        from opentelemetry.sdk.trace.export import BatchSpanProcessor
        from opentelemetry.sdk.util.instrumentation import (
            InstrumentationScope,
        )

        self._otel_trace = otel_trace
        self._ReadableSpan = ReadableSpan
        self._resource = Resource.create({"service.name": service_name})
        self._scope = InstrumentationScope("gubernator_tpu_torch")
        self._processor = BatchSpanProcessor(OTLPSpanExporter())

    def _ctx(self, trace_id: int, span_id: int):
        t = self._otel_trace
        return t.SpanContext(
            trace_id=trace_id, span_id=span_id, is_remote=False,
            trace_flags=t.TraceFlags(t.TraceFlags.SAMPLED),
        )

    def export(self, span: Span) -> None:
        t = self._otel_trace
        readable = self._ReadableSpan(
            name=span.name,
            context=self._ctx(span.context.trace_id, span.context.span_id),
            parent=(
                self._ctx(span.context.trace_id, span.parent_id)
                if span.parent_id is not None else None
            ),
            resource=self._resource,
            attributes=dict(span.attributes),
            events=(),
            links=[
                t.Link(self._ctx(l.trace_id, l.span_id))
                for l in span.links
            ],
            kind=t.SpanKind.INTERNAL,
            instrumentation_scope=self._scope,
            status=t.Status(
                t.StatusCode.ERROR if span.error else t.StatusCode.UNSET,
                span.error,
            ),
            start_time=span.start_ns,
            end_time=span.end_ns,
        )
        self._processor.on_end(readable)

    def shutdown(self) -> None:
        self._processor.shutdown()


class _TraceState:
    """Armed tracing plane: sampler + exporters + counters + the
    recent-span ring.  `_lock` guards only its own counters/deque and is
    never held across another lock (ranked last with flightrec._lock in
    tools/gubguard/lockorder.py)."""

    def __init__(self, service_name, sampler, ratio, exporters,
                 exporter_kind, exporter_error) -> None:
        self.service_name = service_name
        self.sampler = sampler
        self.ratio = ratio
        self.exporters = list(exporters)
        self.exporter_kind = exporter_kind
        self.exporter_error = exporter_error
        self._lock = threading.Lock()
        self.spans_started = 0
        self.spans_exported = 0
        self.spans_dropped = 0
        self.recent: deque = deque(maxlen=RECENT_SPAN_CAP)
        # 64-bit threshold for the traceidratio root decision.
        self._threshold = int(min(max(ratio, 0.0), 1.0) * (1 << 64))

    def sample_root(self, trace_id: int) -> bool:
        return (trace_id & ((1 << 64) - 1)) < self._threshold

    def note_started(self) -> None:
        with self._lock:
            self.spans_started += 1

    def finish(self, span: Span) -> None:
        with self._lock:
            self.recent.append(span)
        for exp in self.exporters:
            try:
                exp.export(span)
                with self._lock:
                    self.spans_exported += 1
            except Exception as e:  # noqa: BLE001 — never fail the caller
                with self._lock:
                    self.spans_dropped += 1
                log.debug("span export failed: %s", e)


_state: Optional[_TraceState] = None
_current: contextvars.ContextVar[Optional[SpanContext]] = (
    contextvars.ContextVar("gubernator_tpu_trace_ctx", default=None)
)
_CURRENT = object()  # sentinel: "resolve the parent from the contextvar"


def enabled() -> bool:
    """One global check — the hot path's whole cost when disabled."""
    return _state is not None


def current_context() -> Optional[SpanContext]:
    if _state is None:
        return None
    return _current.get()


def grpc_metadata():
    """Outbound w3c propagation: (("traceparent", ...),) for the current
    context, or None (no context / tracing disabled) — safe to pass
    straight to grpc's `metadata=` kwarg either way."""
    if _state is None:
        return None
    ctx = _current.get()
    if ctx is None:
        return None
    return (("traceparent", ctx.traceparent()),)


def _new_trace_id() -> int:
    tid = int.from_bytes(os.urandom(16), "big")
    return tid or 1


def _new_span_id() -> int:
    sid = int.from_bytes(os.urandom(8), "big")
    return sid or 1


def _begin(state, name, parent, links, attrs):
    """(span-or-None, child context).  A Span exists only when the
    context is sampled; an unsampled context still propagates so the
    decision stays consistent downstream and across peers."""
    span_id = _new_span_id()
    if parent is not None:
        trace_id = parent.trace_id
        sampled = parent.sampled
        parent_id = parent.span_id
    else:
        trace_id = _new_trace_id()
        sampled = state.sample_root(trace_id)
        parent_id = None
    ctx = SpanContext(trace_id, span_id, sampled)
    if not sampled:
        return None, ctx
    state.note_started()
    return Span(name, ctx, parent_id, attrs, links), ctx


def start_span(
    name: str,
    parent: Optional[SpanContext],
    links: Iterable[Optional[SpanContext]] = (),
    **attrs,
) -> Optional[Span]:
    """Manually managed span (caller must `end()` it) with an EXPLICIT
    parent — the form the cross-thread seams use (coalescer merges, ring
    iterations), where the submitting context was captured earlier.
    Returns None when tracing is disabled or the parent is unsampled."""
    st = _state
    if st is None or parent is None or not parent.sampled:
        return None
    sp, _ctx = _begin(
        st, name, parent, [l for l in links if l is not None], attrs
    )
    return sp


@contextlib.contextmanager
def span(
    name: str,
    parent=_CURRENT,
    links: Iterable[Optional[SpanContext]] = (),
    require_parent: bool = False,
    **attrs,
) -> Iterator[Optional[Span]]:
    """Span context manager; yields the Span (None when unsampled or
    disabled) and binds the child context for the duration so nested
    spans / flight-recorder records / outbound RPCs attribute to it.

    `parent` defaults to the current context; pass an explicit
    SpanContext to re-root (server-side traceparent extract, thread
    hand-offs).  `require_parent=True` makes the span a pure
    pass-through when no parent exists — internal pipeline stages use it
    so an untraced request never starts a spurious root trace."""
    st = _state
    if st is None:
        yield None
        return
    pa = _current.get() if parent is _CURRENT else parent
    if require_parent and pa is None:
        yield None
        return
    sp, ctx = _begin(
        st, name, pa, [l for l in links if l is not None], attrs
    )
    token = _current.set(ctx)
    try:
        yield sp
    except BaseException as e:
        if sp is not None:
            sp.end(error=repr(e))
        raise
    finally:
        _current.reset(token)
        if sp is not None:
            sp.end()


@contextlib.contextmanager
def use_context(ctx: Optional[SpanContext]) -> Iterator[None]:
    """Bind an explicitly carried context on the current thread (ring
    runner, pool workers) without opening a new span."""
    if _state is None or ctx is None:
        yield
        return
    token = _current.set(ctx)
    try:
        yield
    finally:
        _current.reset(token)


def wrap(fn, name: str, parent: Optional[SpanContext], **attrs):
    """Wrap a zero-arg callable in a child span of `parent`, binding the
    context on whichever thread runs it.  Returns `fn` unchanged when
    tracing is disabled or there is no parent — the executor seams call
    this unconditionally and pay nothing in the disabled path."""
    if _state is None or parent is None:
        return fn

    def _traced():
        with span(name, parent=parent, **attrs):
            return fn()

    return _traced


class _ProfilerUnbound:
    """Stands in for `torch.autograd.profiler` until the first stage or
    annotation binds it (importing this module loads no torch: the peer
    client and the load generator import it too).  Its flag reads True,
    so the first use takes the slow path, which binds the real module."""

    _is_profiler_enabled = True


# `torch.autograd.profiler`, whose `_is_profiler_enabled` is True, in every
# thread, only while a torch.profiler records (not in its warm-up).
_tprof = _ProfilerUnbound


def _profiler_recording() -> bool:
    """Whether a torch.profiler is recording now."""
    global _tprof
    if _tprof is _ProfilerUnbound:
        import torch.autograd.profiler as tprof

        _tprof = tprof
    return bool(_tprof._is_profiler_enabled)


@contextlib.contextmanager
def device_step_annotation(name: str = "gubernator_device_step"):
    """Profiler-visible annotation around a device step, nested in the
    current trace context when tracing is armed — host spans and the
    torch.profiler range then line up in a capture.  The range is entered
    only while a profiler records: outside one it costs every use and
    records nothing."""
    with span(name, require_parent=True):
        if _profiler_recording():
            import torch

            with torch.profiler.record_function(name):
                yield
        else:
            yield


# -- engine stages ---------------------------------------------------------
#
# A stage is one step inside an engine call (runtime/backend.py,
# runtime/sketch_backend.py): `t = stage_begin()` before it,
# `stage_end(name, call, t)` after.  `call` is the engine's sequence number
# of the call, so a call's dispatch and fetch stages pair up.  A stage goes
# to two sinks:
#
#   * the stage log, while a torch.profiler records: (name, call, start_ns,
#     end_ns, counts) on `time.time_ns()`, which is the profiler's own host
#     clock (CLOCK_REALTIME; an event's offset is from `trace_start_ns()`).
#     The log is the program's record, never a profiler range: a range
#     would be copied onto the device's timeline, where a trace reader
#     counts it as device work.  It holds the latest recording only: it
#     starts afresh at the first stage that finds the profiler recording
#     after one that found it not recording;
#   * gubscope, when it is armed and a context is bound: a child Span.
#
# With neither on, a stage costs one module-global check and the profiler
# flag's read, and allocates nothing.

STAGE_LOG_CAP = 16384
_stage_log: deque = deque(maxlen=STAGE_LOG_CAP)
# `_log_open`: the last stage found the profiler recording, so the log is
# this recording's.  `_stages_live`: that, or gubscope is armed; while it is
# False a stage reads it and the profiler's flag and returns.
_log_open = False
_stages_live = False


def stage_begin() -> int:
    """The stage's start on the profiler's clock, or 0 where it goes to
    no sink."""
    if not _stages_live and not _tprof._is_profiler_enabled:
        return 0
    return _stage_begin_live()


def _stage_begin_live() -> int:
    global _log_open, _stages_live
    recording = _profiler_recording()
    if recording and not _log_open:
        _stage_log.clear()
    _log_open = recording
    _stages_live = recording or _state is not None
    if recording or (_state is not None and _current.get() is not None):
        return time.time_ns()
    return 0


def stage_end(name: str, call: int, t0: int,
              counts: Optional[Dict[str, int]] = None) -> None:
    """Close the stage begun at `t0` (`stage_begin()`'s value); `counts`
    are counters taken at the same boundary."""
    if not t0:
        return
    t1 = time.time_ns()
    if _log_open:
        _stage_log.append((name, call, t0, t1, counts))
    st = _state
    if st is None:
        return
    parent = _current.get()
    if parent is None or not parent.sampled:
        return
    sp, _ctx = _begin(st, name, parent, (), dict(counts or {}, call=call))
    sp.start_ns = t0
    sp.end()


def stage_records() -> List[tuple]:
    """The stage log of the latest recording: (name, call, start_ns,
    end_ns, counts) in the order the stages ended."""
    return list(_stage_log)


def stage_totals() -> Dict[str, Dict]:
    """Per stage name over the stage log: `count` (records), `calls`
    (distinct calls), `total_ns`, `durations_ns` (for percentiles) and
    `counts` (each counter summed)."""
    out: Dict[str, Dict] = {}
    calls: Dict[str, set] = {}
    for name, call, t0, t1, counts in stage_records():
        t = out.get(name)
        if t is None:
            t = out[name] = {"count": 0, "calls": 0, "total_ns": 0,
                             "durations_ns": [], "counts": {}}
            calls[name] = set()
        t["count"] += 1
        t["total_ns"] += t1 - t0
        t["durations_ns"].append(t1 - t0)
        calls[name].add(call)
        for k, v in (counts or {}).items():
            t["counts"][k] = t["counts"].get(k, 0) + v
    for name, t in out.items():
        t["calls"] = len(calls[name])
    return out


# -- lifecycle / introspection -------------------------------------------

def _resolve_sampler(sampler: Optional[str], sampler_arg) -> tuple:
    """(canonical sampler name, root ratio).  Parent-based behavior is
    structural here (children always inherit), so the parentbased_*
    spellings only choose the ROOT policy."""
    raw = (
        sampler
        or os.environ.get("OTEL_TRACES_SAMPLER")
        or "parentbased_always_on"
    ).strip().lower()
    canon = _SAMPLER_ALIASES.get(raw, raw)
    if canon == "always_on":
        return raw, 1.0
    if canon == "always_off_root":
        return raw, 0.0
    if canon == "always_off":
        return raw, 0.0
    if canon == "traceidratio":
        arg = sampler_arg
        if arg is None:
            arg = os.environ.get("OTEL_TRACES_SAMPLER_ARG", "1.0")
        try:
            ratio = float(arg)
        except (TypeError, ValueError):
            log.warning(
                "bad OTEL_TRACES_SAMPLER_ARG %r; sampling everything", arg
            )
            ratio = 1.0
        return raw, ratio
    log.warning("unknown OTEL_TRACES_SAMPLER %r; using always_on", raw)
    return raw, 1.0


def init_tracing(
    service_name: Optional[str] = None,
    exporter=None,
    sampler: Optional[str] = None,
    sampler_arg=None,
) -> TracingStatus:
    """Arm the tracing plane from the standard OTEL_* env spec
    (OTEL_SERVICE_NAME, OTEL_TRACES_SAMPLER[_ARG],
    OTEL_EXPORTER_OTLP_ENDPOINT) and/or an explicit exporter.

    Returns a TracingStatus with the REAL exporter state: a configured
    OTLP endpoint whose exporter packages are missing reports
    `exporter_error` (spans then stay in-process — recent-span ring +
    breach dumps — instead of silently vanishing).  Disabled outcomes
    (no OTEL_* configuration at all, or sampler `always_off`/`off`)
    leave the hot path span-free; the status says which."""
    global _state, _stages_live
    service_name = (
        service_name
        or os.environ.get("OTEL_SERVICE_NAME")
        or "gubernator-tpu"
    )
    sampler_name, ratio = _resolve_sampler(sampler, sampler_arg)
    endpoint = os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT", "")
    if _SAMPLER_ALIASES.get(sampler_name, sampler_name) == "always_off":
        _state = None
        return TracingStatus(
            False, service_name, sampler_name, 0.0,
            reason="sampler is off; tracing disabled",
        )
    opted_in = (
        exporter is not None
        or bool(endpoint)
        or sampler is not None
        or "OTEL_TRACES_SAMPLER" in os.environ
    )
    if not opted_in:
        _state = None
        return TracingStatus(
            False, service_name, sampler_name, ratio,
            reason=(
                "no OTEL_* configuration and no explicit exporter; "
                "tracing disabled"
            ),
        )
    exporters = []
    exporter_kind = "none"
    exporter_error = None
    if exporter is not None:
        exporters.append(exporter)
        exporter_kind = type(exporter).__name__
    if endpoint:
        try:
            exporters.append(_OTLPBridge(service_name))
            exporter_kind = "otlp"
        except Exception as e:  # noqa: BLE001 — ImportError et al.
            exporter_error = f"OTLP exporter unavailable: {e}"
            log.warning(
                "OTEL_EXPORTER_OTLP_ENDPOINT is set but the OTLP "
                "exporter packages are missing (`pip install "
                "gubernator-tpu[tracing]`); spans will NOT be exported "
                "— they stay in-process (recent-span ring, breach "
                "dumps) only: %s", e,
            )
    _state = _TraceState(
        service_name, sampler_name, ratio, exporters,
        exporter_kind, exporter_error,
    )
    _stages_live = True
    return TracingStatus(
        True, service_name, sampler_name, ratio,
        exporter=exporter_kind, exporter_error=exporter_error,
    )


def shutdown_tracing() -> None:
    """Disarm (tests, daemon teardown): later spans are no-ops again."""
    global _state
    st = _state
    _state = None
    if st is not None:
        for exp in st.exporters:
            close = getattr(exp, "shutdown", None)
            if callable(close):
                try:
                    close()
                except Exception as e:  # noqa: BLE001
                    log.debug("exporter shutdown failed: %s", e)


def debug_vars() -> Dict:
    """The /debug/vars `tracing` block: enabled, sampler, exporter
    status, span counters."""
    st = _state
    if st is None:
        return {"enabled": False}
    with st._lock:
        started = st.spans_started
        exported = st.spans_exported
        dropped = st.spans_dropped
        recent = len(st.recent)
    return {
        "enabled": True,
        "service": st.service_name,
        "sampler": st.sampler,
        "ratio": st.ratio,
        "exporter": {
            "kind": st.exporter_kind,
            "error": st.exporter_error,
        },
        "spans": {
            "started": started,
            "exported": exported,
            "dropped": dropped,
            "recent": recent,
        },
    }


def recent_spans_for(
    trace_ids: Iterable[str], limit: int = 256
) -> List[Dict]:
    """Recently finished spans belonging to the given trace ids (hex
    strings) — the flight recorder attaches these to a breach dump so
    the dump carries the full in-process trace of the offending
    merge."""
    st = _state
    if st is None:
        return []
    want = set(trace_ids)
    if not want:
        return []
    with st._lock:
        spans = list(st.recent)
    out = [
        sp.to_dict() for sp in spans
        if sp.context.trace_id_hex() in want
    ]
    return out[-limit:]
