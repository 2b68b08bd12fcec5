"""The port's microbench (cli/microbench.py) and graft entry points
(graft.py) against gubernator_tpu/cli/microbench.py and the repo-root
__graft_entry__.py, on the CPU.

A 0.3 s microbench of each package prints the same six scenarios with the
same keys, and the port's kernel audit names both kernels; the port's
mesh dry run on one CPU device prints the JAX dry run's lines (the JAX run
on four virtual CPU devices, in a subprocess), all but the final mesh
description; and `entry()`'s decision step answers as JAX
`apply_batch_impl` on the same table and requests, bit for bit."""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops.state import SlotTable as JaxTable
from gubernator_tpu_torch import graft
from gubernator_tpu_torch.ops.state import table_to_host
from gubernator_tpu_torch.ops.step import RESP_ROWS

REPO = Path(__file__).resolve().parents[1]
SCENARIOS = ["peer_rpc", "get_ratelimits", "global", "sketch",
             "healthcheck", "herd_100way"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_lines(cmd, env, timeout=300):
    p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.splitlines()


def test_microbench_scenarios_and_keys_equal_the_jax_one():
    env = dict(os.environ, JAX_PLATFORMS="cpu", GUBER_TPU_PLATFORM="cpu")
    args = ["--seconds", "0.3", "--concurrency", "4"]
    jax_lines = [json.loads(x) for x in run_lines(
        [sys.executable, "-m", "gubernator_tpu.cli.microbench", *args], env)
        if x.startswith("{")]
    port_lines = [json.loads(x) for x in run_lines(
        [sys.executable, "-m", "gubernator_tpu_torch.cli.microbench", *args,
         "--recompile-audit"], env) if x.startswith("{")]
    assert [x["scenario"] for x in jax_lines] == SCENARIOS
    assert [x["scenario"] for x in port_lines] == SCENARIOS + [
        "recompile_audit"]
    for j, p in zip(jax_lines, port_lines):
        assert set(p) == set(j), (j["scenario"], set(p) ^ set(j))
        assert p["ops"] > 0, p
    # On the CPU no kernel library is built or launched: the plain
    # versions serve.
    assert port_lines[-1]["kernels"] == {
        "serve_kernel": {"builds": 0, "launches": 0},
        "cms_kernel": {"builds": 0, "launches": 0},
    }


def test_dryrun_prints_the_jax_dry_runs_lines(capsys):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_out = run_lines(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(4)"], env)
    graft.dryrun_multichip(4, device="cpu")
    port_out = capsys.readouterr().out.splitlines()
    assert len(port_out) == len(jax_out) == 5
    assert port_out[:-1] == jax_out[:-1]
    assert "occupancy [5, 7, 2, 5]" in port_out[0]
    assert port_out[-1].startswith("dryrun_multichip(4): OK — mesh ")
    assert jax_out[-1].startswith("dryrun_multichip(4): OK — mesh ")


def test_entry_step_equals_jax_apply_batch_impl():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", REPO / "__graft_entry__.py")
    jentry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jentry)
    jfn, (jt, jbatch, jnow) = jentry.entry()
    fn, (table, q, now) = graft.entry(device="cpu")
    assert now == int(jnow)
    assert table.key.shape == (4096,) and q.shape == (12, 256)
    np.testing.assert_array_equal(
        q.numpy(), np.stack([np.asarray(a).astype(np.int64)
                             for a in jbatch]))
    for _ in range(2):  # the second step finds every row
        jt, jr = jfn(jt, jbatch, jnp.int64(jnow))
        table, resp = fn(table, q, now)
        want = np.stack([np.asarray(getattr(jr, f)).astype(np.int64)
                         for f in RESP_ROWS])
        np.testing.assert_array_equal(resp.numpy(), want)
    host = table_to_host(table)
    for f in JaxTable._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)), host[f],
                                      err_msg=f)
    assert int((resp[5] != 0).sum()) == 64
    assert set(resp[2, :64].tolist()) == {98}
