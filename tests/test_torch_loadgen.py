"""The port's load generator (gubernator_tpu_torch/loadgen/) against the JAX
package's, on the CPU.

For one seed every scenario's specs and arrival schedules (times and key
draws) are bit-equal across the two packages; the report names the device
from torch (`cpu` here); a short steady run through the port's runner
against port daemons on the CPU ends in a report with exactly the JAX
report's keys, which scripts/bench_gate.py gates; a batched run hits every
key an exact number of times; and a phase boundary's torch.profiler capture
exports a Chrome trace."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gubernator_tpu.core.config import DaemonConfig as JDaemonConfig
from gubernator_tpu.core.config import LoadConfig as JLoadConfig
from gubernator_tpu.loadgen import SCENARIOS as JSCENARIOS
from gubernator_tpu.loadgen import build_schedules as jbuild_schedules
from gubernator_tpu.loadgen import run_scenario as jrun_scenario
from gubernator_tpu.testing import Cluster as JCluster
from gubernator_tpu_torch.core.config import (
    DaemonConfig,
    DeviceConfig,
    LoadConfig,
)
from gubernator_tpu_torch.loadgen import (
    SCENARIOS,
    PhaseSpec,
    PhaseTracker,
    ScenarioSpec,
    build_schedules,
    report,
    run_scenario,
    validate_row,
)
from gubernator_tpu_torch.loadgen import schedule as schedule_mod
from gubernator_tpu_torch.testing.cluster import Cluster

SEED = 20261017
CPU = DeviceConfig(num_slots=4096, ways=8, batch_size=128, platform="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spec_fields(spec):
    return (spec.name, spec.description, spec.limit, spec.window_ms,
            spec.key_universe, spec.tenant, spec.needs_cluster,
            spec.datacenters, sorted(spec.hooks),
            [dataclasses.astuple(p) for p in spec.phases])


@pytest.mark.parametrize("name", sorted(JSCENARIOS))
def test_scenario_arrivals_bit_equal_to_jax(name):
    """The same seed gives each phase the same intended-send times (bit
    for bit) and key draws in both packages."""
    assert sorted(SCENARIOS) == sorted(JSCENARIOS)
    assert spec_fields(SCENARIOS[name]) == spec_fields(JSCENARIOS[name])
    kw = dict(seed=SEED, duration_s=3.0, target_rps=400.0)
    got = build_schedules(SCENARIOS[name], LoadConfig(**kw))
    want = jbuild_schedules(JSCENARIOS[name], JLoadConfig(**kw))
    assert len(got) == len(want) == len(SCENARIOS[name].phases)
    for g, w in zip(got, want):
        assert len(g) > 0 and g.digest() == w.digest()
        assert np.array_equal(g.times_s.view(np.int64),
                              w.times_s.view(np.int64))
        assert np.array_equal(g.key_idx, w.key_idx)


def test_platform_is_read_from_torch():
    assert report._platform() == "cpu"
    assert report._platform("cpu") == "cpu"
    assert report._platform(torch.device("cpu")) == "cpu"
    assert report._platform("cuda") == "cuda"
    assert report._platform(torch.device("cuda", 0)) == "cuda"


def _bench_gate():
    spec = importlib.util.spec_from_file_location(
        "bench_gate",
        Path(__file__).resolve().parent.parent / "scripts" / "bench_gate.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("bench_gate", mod)
    spec.loader.exec_module(mod)
    return mod


def _keys(artifact):
    return (sorted(artifact), [(r["phase"], sorted(r))
                               for r in artifact["results"]])


def test_runner_report_has_the_jax_reports_keys():
    """A short steady run through the port's runner against two port
    daemons on the CPU: the ledger verdict holds exactly, the report says
    `cpu` and has the JAX run's keys row for row, and bench_gate gates it
    against the JAX artifact (same keys, same platform)."""
    cfg = dict(seed=SEED, scenario="steady", duration_s=1.0, clients=4,
               target_rps=120.0)
    c = Cluster.start_with(["", ""], device=CPU,
                           conf_template=DaemonConfig(flightrec=True))
    try:
        got = run_scenario("steady", LoadConfig(**cfg), cluster=c)
    finally:
        c.stop()
    jc = JCluster.start_with(["", ""],
                             conf_template=JDaemonConfig(flightrec=True))
    try:
        want = jrun_scenario("steady", JLoadConfig(**cfg), cluster=jc)
    finally:
        jc.stop()
    v = got["verdict"]
    assert v["client_errors"] == 0 and v["ledger_denied"] == 0
    assert v["ledger_allowed"] == v["client_admitted"] > 0
    art, jart = got["artifact"], want["artifact"]
    assert art["platform"] == jart["platform"] == "cpu"
    assert {r["platform"] for r in art["results"]} == {"cpu"}
    assert _keys(art) == _keys(jart)
    assert sorted(got) == sorted(want)
    assert sorted(v) == sorted(want["verdict"])
    for row in art["results"]:
        validate_row(row)
    json.dumps(art)
    assert _bench_gate().gate(jart, art, threshold=1e9, warn_only=True) == 0


def test_paced_cycle_schedule_is_exact():
    """The port's draw-free kinds: exactly round(rps x duration) arrivals,
    in groups sharing one send time, each key hit n // universe times."""
    s = schedule_mod.build("paced", "cycle", SEED, 1000.0, 3.5, 100,
                           {"group": 250})
    assert len(s) == 3500
    assert np.array_equal(np.bincount(s.key_idx), np.full(100, 35))
    assert len(np.unique(s.times_s)) == 14
    assert np.array_equal(s.times_s[:250], np.zeros(250))
    assert s.times_s[250] == 0.25 and np.all(np.diff(s.times_s) >= 0)
    with pytest.raises(ValueError, match="group"):
        schedule_mod.build("paced", "cycle", SEED, 10.0, 1.0, 4, {"group": 0})


def test_batched_run_hits_every_key_exactly(monkeypatch):
    """batch > 1: the arrivals due together ride GetRateLimits calls of up
    to `batch` requests; every key is hit exactly its paced count, and
    limit 5 admits exactly 5 of them."""
    from gubernator_tpu_torch import client as client_mod

    def verdict(ctx):
        totals = ctx.totals()
        assert totals.errors == 0
        assert totals.per_key_admitted == {k: 5 for k in range(40)}
        assert totals.admitted == 200 and totals.denied == 40 * 3
        return {"admitted": totals.admitted}

    spec = ScenarioSpec(
        name="torch_batched", description="paced cycle batches",
        phases=(PhaseSpec("burst", 1.0, "paced", "cycle",
                          target_rps=320.0, params={"group": 64}),),
        limit=5, window_ms=300_000, key_universe=40,
        tenant="load.batched", verdict=verdict)
    sent = []
    orig = client_mod.AsyncV1Client.get_rate_limits

    async def spy(self, reqs, *a, **kw):
        sent.append(len(reqs))
        return await orig(self, reqs, *a, **kw)

    monkeypatch.setattr(client_mod.AsyncV1Client, "get_rate_limits", spy)
    monkeypatch.setitem(SCENARIOS, spec.name, spec)
    c = Cluster.start_with(["", ""], device=CPU)
    try:
        out = run_scenario(spec.name, LoadConfig(seed=SEED, duration_s=1.0,
                                                 clients=2), cluster=c,
                           batch=32)
    finally:
        c.stop()
    assert out["verdict"]["admitted"] == 200
    assert out["phase_stats"]["burst"]["arrivals"] == 320
    assert sum(sent) == 320 and max(sent) == 32 and len(sent) <= 15
    assert out["artifact"]["platform"] == "cpu"


def test_phase_profile_exports_a_chrome_trace(tmp_path):
    tr = PhaseTracker("steady", profile_dir=str(tmp_path))
    tr.enter("cruise", profile=True)
    torch.ones(8).sum()
    tr.exit()
    trace = tmp_path / "steady-cruise" / "trace.json"
    assert trace.exists()
    assert "traceEvents" in json.loads(trace.read_text())
