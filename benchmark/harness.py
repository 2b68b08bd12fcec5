"""The benchmark's harness: finds a cell's pieces by name, drives its window
and reads its metrics.

Everything that belongs to one configuration, traffic mix, entry or metric
is a file of its own, found by the name that BENCHMARK.json gives it:

- a configuration: benchmark/configs/<config>.json, whose `entry` field
  names its entry module, benchmark/entries/<entry>.py (`Entry`);
- a traffic mix: benchmark/traffic/<traffic>.json, read by the one
  generator (generator.py);
- a metric, end to end or per layer: benchmark/metrics/<name>.py, whose
  `read(ctx)` returns its value, or None where it finds nothing to read.

A run: set-up (the entry's `setup()`: the engine, the inputs from the
seed, the populate or warm-up through the timed entry), then a closed loop
that keeps the mix's `in_flight` calls started for `seconds` seconds,
then a drain.  The rate is every decision the window's calls returned over
the whole window, drain included.  With `trace`, torch.profiler records
the device over TRACE_CALLS calls from about 40% of the window on (every
call dispatched there is also fetched there), and the benchmark's own
spans around each dispatch and fetch label the device's idle gaps.  Once
the window has closed: the device's peak memory, a look for JAX in the
process, the entry's state read back and freed, and the check against the
plain reference.
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import sys
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional

from benchmark import yardstick

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gubernator_tpu")

# Where the traced part of the window starts, as a share of it, and its
# calls (fewer only where the window closes first).
TRACE_FROM, TRACE_CALLS = 0.4, 512
# Spans before this share of the window are the warm start, not read.
STEADY_FROM = 0.2
# The benchmark's own spans in a trace (the profiler also copies them to
# the device's timeline as annotations, which are no device work).
SPAN_NAMES = ("bench.dispatch", "bench.fetch")


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package is loaded in the process."""


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the run may not hold, compared
    whole (gubernator_tpu_torch is not gubernator_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_module(path: Path):
    """Import the file at `path` as a module of its own."""
    name = "benchmark_plugin_" + "_".join(
        path.relative_to(BENCH_DIR).with_suffix("").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


class Cell:
    """One workload of BENCHMARK.json with its pieces resolved by name."""

    def __init__(self, spec: dict, workload: str, root: Path = ROOT) -> None:
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.chips = int(self.workload["chips"])
        conf = {c["name"]: c for c in spec["configs"]}[
            self.workload["config"]]
        self.config = json.loads((root / conf["file"]).read_text())
        self.traffic = json.loads(
            (BENCH_DIR / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.entry_path = BENCH_DIR / "entries" / f"{self.config['entry']}.py"

        def listed(m: dict) -> bool:
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in spec["end_to_end"] if listed(m)]
        self.per_layer = [m for m in spec["per_layer"] if listed(m)]


def _merge(base: dict, over: Optional[dict]) -> dict:
    """`base` with the keys of `over` replaced (nested dicts merged)."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def read_metrics(specs: List[dict], ctx: dict) -> Dict[str, dict]:
    out = {}
    for m in specs:
        value = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py").read(
            ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def summarize_trace(prof, log) -> dict:
    """Device time from a torch.profiler run over the traced calls: the
    union of device events inside the traced window, the copies, the
    kernels launched inside a dispatch span, the top operations and the
    longest idle gaps labelled by the span the host was in."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    evs = list(prof.events())
    host = sorted((e.time_range.start, e.time_range.end,
                   e.name.split(".", 1)[1]) for e in evs
                  if e.name in SPAN_NAMES and e.device_type != cuda)
    dev = [e for e in evs
           if e.device_type == cuda and e.name not in SPAN_NAMES]
    out = {"busy_s": 0.0, "window_s": 0.0, "copy_s": 0.0, "kernel_s": 0.0,
           "device_ops": [], "idle_gaps": []}
    if not host:
        return out
    lo, hi = host[0][0], max(h[1] for h in host)
    out["window_s"] = (hi - lo) / 1e6
    spans = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
             for e in dev if e.time_range.end > lo and e.time_range.start < hi]
    out["busy_s"] = yardstick.busy_union(spans) / 1e6
    disp = [(a, b) for a, b, kind in host if kind == "dispatch"]
    starts = [a for a, _ in disp]
    runtime = {e.id: e.time_range.start for e in evs
               if e.device_type != cuda and e.name.startswith("cu")}
    by_name: Dict[str, float] = {}
    linked = unlinked = outside = 0
    for e in dev:
        dur = (e.time_range.end - e.time_range.start) / 1e6
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
        low = e.name.lower()
        if "memcpy" in low:
            out["copy_s"] += dur
            continue
        if "memset" in low:
            continue
        t = runtime.get(e.id)
        if t is None:
            unlinked += 1
        else:
            i = bisect.bisect_right(starts, t) - 1
            if i < 0 or t > disp[i][1]:
                outside += 1
                continue
            linked += 1
        out["kernel_s"] += dur
    log(f"trace: {len(dev)} device events over {out['window_s']:.6f} s; "
        f"kernels launched in a dispatch span {linked}, outside {outside}, "
        f"with no launch found {unlinked} (counted)")
    out["device_ops"] = [[k, v] for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:10]]
    gaps = yardstick.idle_gaps(spans, lo, hi)
    hstarts = [a for a, _, _ in host]
    labelled = []
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(hstarts, mid) - 1
        label = (f"host in {host[i][2]}" if i >= 0 and mid <= host[i][1]
                 else "host between calls")
        labelled.append([label, (b - a) / 1e6])
    out["idle_gaps"] = sorted(labelled, key=lambda g: -g[1])[:10]
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, device: str = "cuda",
             overrides: Optional[dict] = None,
             control: bool = False,
             t_start: Optional[float] = None,
             log: Optional[Callable[[str], None]] = None) -> dict:
    """One run of a cell; returns the result line's object.  With
    `control`, the entry module's `Control` takes the place of its `Entry`:
    the check's control, judged by the same verdict."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    overrides = overrides or {}
    cell = Cell(load_spec(root), workload, root)
    config = _merge(cell.config, overrides.get("config"))
    traffic = _merge(cell.traffic, overrides.get("traffic"))
    module = load_module(cell.entry_path)
    entry = (module.Control if control else module.Entry)(
        config, traffic, seed, device, log)
    import torch

    on_card = device.startswith("cuda")
    entry.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    depth = entry.in_flight
    inflight: deque = deque()
    dispatch_s, fetch_s = [], []
    done_at: List[float] = []  # when each call's fetch returned
    decisions = 0
    prof, traced, trace_done, entered = None, False, False, False
    i = n_traced = 0
    if trace:
        # The tracer is entered where the traced part starts: one entered
        # before the window holds every device event from its entry, and
        # on an H100 reading 20 s of them back took some 90 s.  Its
        # start-up, seconds on some machines, is paid here instead, by a
        # throwaway tracer before the window.  It records from the step()
        # after its warm-up to the next.
        from torch.profiler import ProfilerActivity, profile, schedule

        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        t_warm = time.perf_counter()
        with profile(activities=activities):
            if on_card:
                torch.cuda.synchronize()
        log(f"tracer started once in {time.perf_counter() - t_warm:.3f} s")
        prof = profile(activities=activities,
                       schedule=schedule(wait=0, warmup=1, active=1,
                                         repeat=1))
    t0 = time.perf_counter()
    t_end = t0 + seconds
    steady_from = t0 + STEADY_FROM * seconds

    def finish_one() -> None:
        nonlocal decisions
        tok, t_disp, was_traced = inflight.popleft()
        a = time.perf_counter()
        if traced:
            with torch.profiler.record_function("bench.fetch"):
                n = entry.fetch(tok)
        else:
            n = entry.fetch(tok)
        b = time.perf_counter()
        decisions += n
        done_at.append(b)
        if t_disp >= steady_from and not was_traced:
            fetch_s.append(b - a)

    def stop_trace() -> None:
        nonlocal traced
        while inflight:
            finish_one()
        if on_card:
            torch.cuda.synchronize()
        prof.step()  # stop recording
        traced = entry.traced = False

    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if trace and not traced and not trace_done \
                and now >= t0 + TRACE_FROM * seconds:
            while inflight:
                finish_one()
            t_enter = time.perf_counter()
            prof.__enter__()  # the tracer's warm-up
            prof.step()  # start recording
            log(f"tracer entered in {time.perf_counter() - t_enter:.3f} s")
            traced = entry.traced = entered = True
        elif traced and n_traced >= TRACE_CALLS:
            stop_trace()
            trace_done = True
            continue
        a = time.perf_counter()
        if traced:
            with torch.profiler.record_function("bench.dispatch"):
                tok = entry.dispatch(i)
            n_traced += 1
        else:
            tok = entry.dispatch(i)
        b = time.perf_counter()
        if a >= steady_from and not traced:
            dispatch_s.append(b - a)
        inflight.append((tok, a, traced))
        i += 1
        if len(inflight) >= depth:
            finish_one()
    while inflight:
        finish_one()
    if traced:
        stop_trace()
    window_s = time.perf_counter() - t0
    if entered:
        prof.__exit__(None, None, None)
    else:
        prof = None  # the window closed before its traced part
    tenths = [0] * 10
    for t in done_at:
        tenths[min(int((t - t0) / window_s * 10), 9)] += 1
    log(f"window: {i} calls, {decisions} decisions in {window_s:.4f} s; "
        f"calls done in each tenth of it: {tenths}")

    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": (torch.cuda.get_device_name(torch.device(device))
                         if on_card else "cpu"),
                "count": cell.chips,
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(
                    torch.device(device))) if on_card else 0)}
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"loaded in the process: {', '.join(found)}")

    summary = None
    if prof is not None:
        t_read = time.perf_counter()
        summary = summarize_trace(prof, log)
        log(f"trace read in {time.perf_counter() - t_read:.3f} s")
        if on_card:
            dev_info["busy_s"] = summary["busy_s"]
            dev_info["window_s"] = summary["window_s"]
    ctx = {
        "engine": entry.kind,
        "decisions": decisions,
        "window_s": window_s,
        "setup_s": setup_s,
        "calls": i,
        "dispatch_s": dispatch_s,
        "fetch_s": fetch_s,
        "trace": summary,
        "trace_calls": n_traced,
        "traced_bytes": entry.traced_bytes if summary else 0,
        "hbm_bytes_per_s": (yardstick.hbm_bytes_per_s(dev_info["kind"])
                            if on_card and dev_info["kind"]
                            == yardstick.SXM_NAME else None),
    }
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           ctx)

    entry.read_state()
    entry.free()
    t_check = time.perf_counter()
    compared = entry.verify()
    log(f"check in {time.perf_counter() - t_check:.3f} s")
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"loaded in the process: {', '.join(found)}")
    correct = all(v <= lim for v, lim in compared.values())
    result = {"correct": correct, "attempted": decisions, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        log(f"compared {k} = {v}, limit {lim}")
    return result
