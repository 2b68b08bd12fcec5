"""The port's service-path benchmark (gubernator_tpu_torch/cli/bench_e2e.py)
against the repo-root bench_e2e.py, on the CPU.

`build_payload` and `_percentiles` give the root harness's bytes and
numbers; one narrowed run of each package (the serve-mode sweep cut to
pipelined, the client sweep to python, no depth sweep) prints the same
configs in the same order, each line with the same keys, `platform: cpu`
in both summaries, every throughput line with checks and no error.  Each
run is a subprocess with its own time limit."""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gubernator_tpu_torch.cli import bench_e2e

REPO = Path(__file__).resolve().parents[1]
NARROW = ["--seconds", "0.2", "--concurrency", "4", "--pipeline-depth", "",
          "--serve-mode", "pipelined", "--client-mode", "python"]


def root_bench_e2e():
    spec = importlib.util.spec_from_file_location(
        "bench_e2e", REPO / "bench_e2e.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lines_of(cmd, env) -> list:
    p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return [json.loads(x) for x in p.stdout.splitlines()
            if x.startswith("{")]


@pytest.fixture(scope="module")
def narrowed_runs():
    """(JAX lines, port lines) of the narrowed run, one package after the
    other."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("GUBER_TPU_PLATFORM", None)
    jax_lines = lines_of([sys.executable, "bench_e2e.py", *NARROW], env)
    env["GUBER_TPU_PLATFORM"] = "cpu"
    port_lines = lines_of(
        [sys.executable, "-m", "gubernator_tpu_torch.cli.bench_e2e",
         *NARROW], env)
    return jax_lines, port_lines


def test_build_payload_and_percentiles_equal_the_root_harness():
    root = root_bench_e2e()
    cases = [
        ([("bench_token", f"k{i}") for i in range(1000)], {}),
        ([("bench_leaky", f"z{k}") for k in (3, 3, 99)],
         dict(algorithm=1, limit=1_000_000, duration=60_000)),
        ([("bench_global", "g0")], dict(behavior=2, hits=0, burst=7)),
        ([], {}),
    ]
    for names_keys, kw in cases:
        assert (bench_e2e.build_payload(names_keys, **kw)
                == root.build_payload(names_keys, **kw))
    lat = list(np.random.default_rng(5).lognormal(np.log(1e-3), 0.9, 999))
    assert bench_e2e._percentiles(lat) == root._percentiles(lat)


def test_narrowed_runs_print_the_same_configs_in_order(narrowed_runs):
    jax_lines, port_lines = narrowed_runs
    assert ([x["config"] for x in port_lines]
            == [x["config"] for x in jax_lines])
    assert port_lines[-1]["config"] == "summary"


def test_narrowed_runs_lines_have_the_same_keys(narrowed_runs):
    jax_lines, port_lines = narrowed_runs
    for j, p in zip(jax_lines, port_lines):
        assert set(p) == set(j), (j["config"], set(p) ^ set(j))
    # The summary's nested blocks, which scripts/bench_gate.py reads.
    js, ps = jax_lines[-1], port_lines[-1]
    assert set(ps["device"]) == set(js["device"])
    assert set(ps["configs"]) == set(js["configs"])


def test_narrowed_runs_are_on_the_cpu_with_checks_and_no_error(
        narrowed_runs):
    jax_lines, port_lines = narrowed_runs
    assert jax_lines[-1]["platform"] == port_lines[-1]["platform"] == "cpu"
    assert port_lines[-1]["device"] == {"num_slots": 1 << 18,
                                        "batch_size": 4096}
    for line in port_lines:
        assert "error" not in line, line
        if "checks" in line:
            assert line["checks"] > 0, line
    bound = next(x for x in port_lines
                 if x["config"] == "colocated_latency_bound")
    assert bound["device_step_exec_src"] == "host-clock-plain-cpu"
    assert bound["device_step_exec_ms"] > 0
