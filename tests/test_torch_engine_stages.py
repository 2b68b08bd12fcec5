"""The engines' stages (gubernator_tpu_torch/runtime/tracing.py `stage_begin`
/ `stage_end`) on the CPU: nothing is logged and no span is made while
neither sink is on; under a recording torch.profiler one call of the exact
engine (`TorchBackend.step_rounds_begin` and its fetch) and one of the
sketch engine (`SketchBackend.check_cols_begin` and its fetch) log their
five stages under one call number, on the profiler's clock and never as a
profiler event; a new recording starts the log afresh; the lane counter;
the stages as gubscope children of a bound span; the same answers armed or
not; the ring's device-step annotation entering no profiler range while
no profiler records; and the crossings of one call of each engine (the
GLOBAL engine's on a 4-shard mesh) through the device boundary
(runtime/place.py `DevicePlace`).
"""
from __future__ import annotations

import tracemalloc
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gubernator_tpu_torch.core.clock import Clock
from gubernator_tpu_torch.core.config import DeviceConfig, SketchTierConfig
from gubernator_tpu_torch.core.hashing import key_hash64
from gubernator_tpu_torch.core.types import Behavior, RateLimitReq
from gubernator_tpu_torch.ops.batch import empty_batch, pack_requests_grid
from gubernator_tpu_torch.parallel.global_sync import GlobalEngine, arrival_dev
from gubernator_tpu_torch.parallel.sharded import MeshBackend
from gubernator_tpu_torch.runtime import tracing
from gubernator_tpu_torch.runtime.backend import TorchBackend
from gubernator_tpu_torch.runtime.place import DevicePlace
from gubernator_tpu_torch.runtime.sketch_backend import SketchBackend
from gubernator_tpu_torch.testing.tracing import memory_tracing

T0_NS = 1_700_000_000_123 * 1_000_000
EXACT = ["exact.pack", "exact.stage", "exact.launch", "exact.stage",
         "exact.wait", "exact.tally"]
SKETCH = ["sketch.prep", "sketch.stage", "sketch.launch", "sketch.stage",
          "sketch.wait", "sketch.answer"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool gains nothing here, and one pool
    per test worker would oversubscribe the CPU the workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def exact_engine(batch_size=256, num_slots=4096):
    clock = Clock()
    clock.freeze(T0_NS)
    return TorchBackend(DeviceConfig(num_slots=num_slots, ways=8,
                                     batch_size=batch_size, platform="cpu"),
                        clock=clock)


def exact_round(n, batch_size=256, seed=1):
    """One round of `n` active lanes from lane 0: token and leaky buckets,
    limits 1-5, so some lanes go over limit."""
    rng = np.random.default_rng(seed)
    db = empty_batch(batch_size)
    db.key_hash[:n] = rng.integers(1, 2**62, n)
    db.hits[:n] = 1
    db.limit[:n] = db.burst[:n] = rng.integers(1, 6, n)
    db.duration[:n] = 60_000
    db.algo[:n] = rng.integers(0, 2, n)
    db.active[:n] = True
    return db


def sketch_engine():
    clock = Clock()
    clock.freeze(T0_NS)
    return SketchBackend(SketchTierConfig(names=["cms"], width=1024,
                                          window_ms=1000, batch_size=64),
                         clock=clock, device="cpu")


def sketch_cols(n=150, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 40, n).astype(np.int64),
            np.ones(n, dtype=np.int64),
            rng.integers(1, 4, n).astype(np.int64))


def exact_call(be, db):
    return be.step_rounds_begin([db])()


def sketch_call(sb, cols):
    return sb.check_cols_begin(*cols)()


def recorded(fn):
    """Run `fn` under a recording torch.profiler; (its value, the stage
    log, the profiler).  A stage outside it first, as the calls before a
    benchmark's traced window are: the log is the last recording's until
    a stage finds the profiler not recording."""
    tracing.stage_begin()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, tracing.stage_records(), prof


def test_no_stage_and_no_span_while_neither_sink_is_on(monkeypatch):
    be, sb = exact_engine(), sketch_engine()
    recorded(lambda: exact_call(be, exact_round(10)))
    before = tracing.stage_records()

    def no_span(*a, **k):
        raise AssertionError("a span was made with gubscope off")

    monkeypatch.setattr(tracing, "_begin", no_span)
    assert tracing.stage_begin() == 0
    exact_call(be, exact_round(10, seed=3))
    sketch_call(sb, sketch_cols())
    assert tracing.stage_records() == before


def test_stages_off_allocate_nothing():
    tracing.stage_begin()  # binds the profiler's module
    tracemalloc.start()
    try:
        snap = tracemalloc.take_snapshot()
        for call in range(1000, 2000):
            t = tracing.stage_begin()
            tracing.stage_end("exact.pack", call, t)
        grown = tracemalloc.take_snapshot().compare_to(snap, "filename")
    finally:
        tracemalloc.stop()
    assert not [d for d in grown if d.traceback[0].filename
                == tracing.__file__ and d.size_diff > 0]


@pytest.mark.parametrize("engine", ["exact", "sketch"])
def test_one_call_logs_its_five_stages_under_one_call(engine):
    if engine == "exact":
        be = exact_engine()
        _, recs, _ = recorded(lambda: exact_call(be, exact_round(100)))
        want = EXACT
    else:
        sb = sketch_engine()
        _, recs, _ = recorded(lambda: sketch_call(sb, sketch_cols()))
        want = SKETCH
    assert [r[0] for r in recs] == want
    assert len({r[1] for r in recs}) == 1
    assert all(0 < r[2] <= r[3] for r in recs)
    assert all(a[3] <= b[2] for a, b in zip(recs, recs[1:]))


def test_stages_are_on_the_profilers_clock_and_never_its_events():
    be, sb = exact_engine(), sketch_engine()

    def calls():
        with torch.profiler.record_function("test.calls"):
            exact_call(be, exact_round(50))
            sketch_call(sb, sketch_cols())

    _, recs, prof = recorded(calls)
    assert [r[0] for r in recs] == EXACT + SKETCH
    names = {e.name for e in prof.events()}
    assert "test.calls" in names and not names & set(EXACT + SKETCH)
    (outer,) = [e for e in prof.events() if e.name == "test.calls"]
    start = prof.profiler.kineto_results.trace_start_ns()
    lo = start + outer.time_range.start * 1000
    hi = start + outer.time_range.end * 1000
    assert all(lo <= r[2] <= r[3] <= hi for r in recs)


def test_a_new_recording_starts_the_log_afresh():
    be = exact_engine()
    _, first, _ = recorded(lambda: [exact_call(be, exact_round(20, seed=s))
                                    for s in range(3)])
    exact_call(be, exact_round(20, seed=9))  # no recording between
    assert tracing.stage_records() == first
    _, second, _ = recorded(lambda: exact_call(be, exact_round(20)))
    assert len({r[1] for r in first}) == 3
    assert [r[0] for r in second] == EXACT
    assert {r[1] for r in second}.isdisjoint({r[1] for r in first})


def test_lane_counter_of_1000_lanes_at_tier_32768():
    from benchmark.stages import lane_fill

    be = exact_engine(batch_size=32768, num_slots=1 << 15)
    _, recs, _ = recorded(lambda: exact_call(be, exact_round(1000, 32768)))
    (pack,) = [r for r in recs if r[0] == "exact.pack"]
    assert pack[4] == {"lanes": 1024, "active": 1000}
    assert tracing.stage_totals()["exact.pack"]["counts"] == pack[4]
    assert lane_fill({"engine": "exact"}, "exact") == 100.0 * 1000 / 1024
    assert lane_fill({"engine": "sketch"}, "exact") is None


def test_lane_counter_of_full_rounds_and_of_a_second_round():
    from benchmark.stages import lane_fill

    be = exact_engine()
    _, recs, _ = recorded(lambda: exact_call(be, exact_round(256)))
    assert [r[4] for r in recs if r[4]] == [{"lanes": 256, "active": 256}]
    assert lane_fill({"engine": "exact"}, "exact") == 100.0
    # A key met twice goes to a second round, which walks as wide as the
    # first: two rounds of 300 and 100 requests, 384 lanes each.
    be = exact_engine(batch_size=1024)
    rounds = exact_round(300, 1024)
    again = exact_round(300, 1024)
    again.active[100:] = False
    _, recs, _ = recorded(lambda: be.step_rounds([rounds, again]))
    (pack,) = [r for r in recs if r[0] == "exact.pack"]
    assert pack[4] == {"lanes": 768, "active": 400}
    assert lane_fill({"engine": "exact"}, "exact") == 100.0 * 400 / 768


def test_stages_are_children_of_the_bound_span():
    be, sb = exact_engine(), sketch_engine()
    with memory_tracing() as exp:
        with tracing.span("fastpath.dispatch") as disp:
            fetch = be.step_rounds_begin([exact_round(30)])
            fetch_cols = sb.check_cols_begin(*sketch_cols())
        with tracing.span("fastpath.fetch") as fet:
            fetch()
            fetch_cols()
        tracing.stage_end("exact.pack", 1, tracing.stage_begin())
    kids = {sp.name for sp in exp.children_of(disp)}
    assert kids == {"exact.pack", "exact.stage", "exact.launch",
                    "sketch.prep", "sketch.stage", "sketch.launch"}
    assert [sp.name for sp in exp.children_of(fet)] == [
        "exact.wait", "exact.tally", "sketch.wait", "sketch.answer"]
    stages = [sp for sp in exp.spans() if sp.name.startswith("exact.")]
    assert len(stages) == 6  # the unparented stage made no span
    assert len({sp.attributes["call"] for sp in stages}) == 1
    pack = exp.by_name("exact.pack")[0]
    assert pack.attributes["lanes"] == 128
    assert pack.attributes["active"] == 30


@pytest.mark.parametrize("engine", ["exact", "sketch"])
def test_answers_and_state_are_the_same_armed_or_not(engine):
    def run():
        """Four calls' answers, then the engine's state: dicts of arrays."""
        if engine == "exact":
            be = exact_engine()
            return [exact_call(be, exact_round(200, seed=s % 2))[0]
                    for s in range(4)] + [be.snapshot()]
        sb = sketch_engine()
        return [dict(zip("srt", sketch_call(sb, sketch_cols(seed=s % 2))))
                for s in range(4)] + [{"cur": sb.state.cur.numpy(),
                                       "prev": sb.state.prev.numpy()}]

    plain = run()
    with memory_tracing() as exp:
        with tracing.span("bench"):
            armed, recs, _ = recorded(run)
    assert len(recs) == 4 * 6 and exp.spans()
    assert len(armed) == len(plain) == 5
    for x, y in zip(plain, armed):
        assert x.keys() == y.keys()
        assert all(np.array_equal(x[k], y[k]) for k in x)


def test_device_step_annotation_enters_a_range_only_while_recording(
        monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with tracing.device_step_annotation("ring.step"):
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.device_step_annotation("ring.step"):
            pass
    assert entered == ["ring.step"]
    assert "ring.step" in {e.name for e in prof.events()}


def global_engine(n_shards=4, batch_size=64):
    clock = Clock()
    clock.freeze(T0_NS)
    return GlobalEngine(MeshBackend(
        DeviceConfig(num_slots=4096, ways=8, batch_size=batch_size,
                     num_shards=n_shards, platform="cpu"), clock=clock))


def global_call(eng, n=40):
    """serve_packed of `n` GLOBAL keys in use_cached grid rounds routed by
    arrival, as the fast lane packs them, and the fetch of its answers."""
    route = lambda key: arrival_dev(key_hash64(key), eng.n)  # noqa: E731
    reqs = [RateLimitReq(name="g", unique_key=f"k{i}", hits=1, limit=5,
                         duration=60_000, behavior=int(Behavior.GLOBAL))
            for i in range(n)]
    packed = pack_requests_grid(reqs, eng.b.cfg.batch_size, eng.n, route,
                                eng.clock)
    for db in packed.rounds:
        np.copyto(db.use_cached, db.active)
    pend = [(r, r.hits, route(r.hash_key())) for r in reqs]
    return eng.fetch_packed(eng.serve_packed(packed.rounds, pend)[0])


@pytest.mark.parametrize("engine", ["exact", "sketch", "global"])
def test_one_call_crosses_the_device_boundary_three_times_up_once_down(
        engine, monkeypatch):
    """Each place an engine call runs on takes three uploads (the request
    block, the clock and the sequence word; the sketch's keys, hits and
    limits) and one fetch of its answers: the exact engine's and the
    sketch's one place, and each of the GLOBAL engine's four shards."""
    if engine == "exact":
        be = exact_engine()
        places, call = [be.place], lambda: exact_call(be, exact_round(100))
    elif engine == "sketch":
        sb = sketch_engine()
        places, call = [sb.place], lambda: sketch_call(sb, sketch_cols())
    else:
        eng = global_engine()
        places, call = eng.b.shards, lambda: global_call(eng)
    seen = {"upload": Counter(), "fetch": Counter()}
    for name, count in seen.items():
        real = getattr(DevicePlace, name)

        def counted(self, *a, _real=real, _count=count):
            _count[self] += 1
            return _real(self, *a)

        monkeypatch.setattr(DevicePlace, name, counted)
    out = call()
    assert len(out) >= 1
    assert seen["upload"] == {p: 3 for p in places}
    assert seen["fetch"] == {p: 1 for p in places}
