"""The engines' stage log, as the per-layer metrics `stage_ms.<engine>.<stage>`
and `lane_fill.exact` read it.

While the profiler records, the program logs each stage of an engine call
(gubernator_tpu_torch/runtime/tracing.py `stage_records`): (name, call,
start_ns, end_ns, counts), on the host clock the profiler also reads.  The
log is the program's own record, never a profiler range, so nothing of it
reaches the trace's device timeline.  It holds the latest recording: the
traced calls, each dispatched and fetched inside it.  A program without the
log gives no value.
"""
from __future__ import annotations

from typing import List, Optional


def records(engine: str) -> List[tuple]:
    """The log's records of `engine`'s stages ("exact" or "sketch")."""
    from gubernator_tpu_torch.runtime import tracing

    read = getattr(tracing, "stage_records", None)
    if read is None:
        return []
    return [r for r in read() if r[0].startswith(engine + ".")]


def stage_ms(ctx: dict, engine: str, stage: str) -> Optional[float]:
    """Mean host milliseconds of `engine.stage` a traced call: its records'
    total over the engine's traced calls (a stage opened twice a call
    counts both)."""
    if ctx["engine"] != engine:
        return None
    recs = records(engine)
    name = f"{engine}.{stage}"
    mine = [r for r in recs if r[0] == name]
    if not mine:
        return None
    calls = len({r[1] for r in recs})
    return sum(r[3] - r[2] for r in mine) / calls / 1e6


def lane_fill(ctx: dict, engine: str) -> Optional[float]:
    """Lanes that carry a request over lanes shipped, across the traced
    calls' dispatches, in percent."""
    if ctx["engine"] != engine:
        return None
    counts = [r[4] for r in records(engine) if r[4]]
    shipped = sum(c["lanes"] for c in counts)
    if not shipped:
        return None
    return 100.0 * sum(c["active"] for c in counts) / shipped
