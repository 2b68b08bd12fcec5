"""The port's headline bench (gubernator_tpu_torch/cli/bench.py) against the
JAX bench's decision step, on the CPU.

The port expands key columns into packed rounds on the device, populates
the table with K1 dispatches of many rounds and times one-round K1
dispatches; on the CPU K1's wrapper takes its plain version.  Held here:
the expansion equals the JAX bench's `batch_from_keys` (bench.py:147-170);
a whole CPU run of the module function leaves the table that JAX
`apply_batch_impl` leaves after the same populate chunks and the same
staged batches in the same order, bit for bit, at 18% load and at the
bench's 61% load, where full buckets evict rows; a staged round's responses
equal JAX's; the fed round (host-packed, uploaded each step) equals JAX
`apply_batch_packed_q` through both the bench's stepper and the backend's
`_launch`; the run's line has exactly the JAX bench's keys; and without a
card the CLI prints the JAX skip line's shape and exits 2."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import step as jstep
from gubernator_tpu.ops.state import SlotTable as JaxTable
from gubernator_tpu.ops.state import init_table as jinit_table
from gubernator_tpu.ops.step import DeviceBatchJ, apply_batch_impl
from gubernator_tpu_torch.cli import bench
from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.ops.state import init_table, table_to_host
from gubernator_tpu_torch.ops.step import INSERT_ROUNDS, RESP_ROWS
from gubernator_tpu_torch.runtime.backend import TorchBackend

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL_ENV = {"BENCH_BATCH": "256", "BENCH_FED_BATCH": "64"}
RUN_SLOTS = 1 << 14
# 3000 keys fill 2^14 slots to 18%, where no bucket overflows; 10000 fill
# them to 61%, the load of the bench's 10M keys in 2^24 slots, where full
# buckets evict rows.
# bench.py's metric_line and its fed result (bench.py:73-80, 325-350).
JAX_LINE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "fed_decisions_per_sec",
    "fed_vs_baseline", "fed_batch", "fed_link_bytes_per_decision",
    "fed_implied_link_MBps", "fed_note",
}

_apply = jax.jit(apply_batch_impl, static_argnames=("ways",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_batch_from_keys(ks) -> DeviceBatchJ:
    """bench.py:147-170, the JAX bench's expansion of a key column."""
    batch = ks.shape[0]
    active = ks != 0
    algo = (
        (ks.astype(jnp.uint64) >> jnp.uint64(7)) & jnp.uint64(1)
    ).astype(jnp.int32)
    limit = jnp.full((batch,), 1000, jnp.int64)
    zi = jnp.zeros((batch,), jnp.int64)
    zb = jnp.zeros((batch,), jnp.bool_)
    return DeviceBatchJ(
        key_hash=ks, hits=active.astype(jnp.int64), limit=limit,
        duration=jnp.full((batch,), 3_600_000, jnp.int64), algo=algo,
        burst=limit, reset_remaining=zb, is_greg=zb, greg_expire=zi,
        greg_duration=zi, active=active, use_cached=zb,
    )


def jax_packed(resp) -> np.ndarray:
    return np.stack([np.asarray(getattr(resp, f)).astype(np.int64)
                     for f in RESP_ROWS])


def assert_tables_equal(jt: JaxTable, host) -> None:
    for f in JaxTable._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)), host[f],
                                      err_msg=f)


def seeded_keys(seed: int, n: int) -> np.ndarray:
    ks = np.random.default_rng(seed).integers(1, 1 << 63, size=n,
                                              dtype=np.int64)
    ks[::7] = 0  # inactive lanes
    return ks


@pytest.fixture(scope="module", params=[3000, 10_000],
                ids=["3000_keys", "10000_keys_bench_load"])
def small_run(request):
    """One CPU run of the module function at 2^14 slots, 256 lanes a
    round, 64 fed lanes, with 3000 or 10000 keys."""
    env = {**SMALL_ENV, "BENCH_KEYS": str(request.param)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield bench.run(RUN_SLOTS, CPU)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_batch_from_keys_equals_the_jax_expansion():
    ks = seeded_keys(1, 512)
    q = bench.batch_from_keys(torch.from_numpy(ks)).numpy()
    jb = jax_batch_from_keys(jnp.asarray(ks))
    want = np.stack([np.asarray(a).astype(np.int64) for a in jb])
    np.testing.assert_array_equal(q, want)
    # The fed rounds' host packing gives the same active lanes.
    fed = bench.pack_q(ks[ks != 0][:100], 128)
    np.testing.assert_array_equal(
        fed[:, :100],
        bench.batch_from_keys(torch.from_numpy(ks[ks != 0][:100])).numpy())
    assert not fed[:, 100:].any()


def test_cpu_run_table_bit_exact_vs_jax_replay(small_run):
    """The run's table after the populate, the warm-up and every timed
    round equals JAX apply_batch_impl over the same chunks and staged
    batches, in the same order, at the same `now`: at the bench's load
    the two packages evict the same rows."""
    r = small_run
    batch, n_keys = 256, len(r.key_pool)
    assert len(r.applied) > 2 and r.applied[:3] == [0, 1, 0]
    now = jnp.int64(r.now)
    jt = jinit_table(RUN_SLOTS)
    n_chunks = (n_keys + batch - 1) // batch
    padded = np.zeros(n_chunks * batch, dtype=np.int64)
    padded[:n_keys] = r.key_pool
    for ks in padded.reshape(n_chunks, batch):
        jt, _ = _apply(jt, jax_batch_from_keys(jnp.asarray(ks)), now, ways=8)
    staged = [jax_batch_from_keys(jnp.asarray(r.key_pool[r.staged_idx[i]]))
              for i in range(bench.N_STAGED)]
    for i in r.applied:
        jt, _ = _apply(jt, staged[i], now, ways=8)
    host = table_to_host(r.table)
    assert_tables_equal(jt, host)
    # chip_smoke's spot check on the card, over staged batch 0 (hits: the
    # populate's one and one a round that carried the key).  A key whose
    # bucket holds at most INSERT_ROUNDS pool keys holds 1000 - hits; any
    # other key holds 1000 - hits up to 999 (it re-entered after an
    # eviction), or is missing from a bucket whose ways all hold other
    # keys.
    hits = 1 + np.bincount(r.staged_idx[r.applied].ravel(),
                           minlength=n_keys)
    nb = RUN_SLOTS // 8
    per_bucket = np.bincount(r.key_pool & (nb - 1), minlength=nb)
    slot = {k: s for s, k in enumerate(host["key"]) if k}
    counts = {"small": 0, "found": 0, "missing": 0}
    for j in r.staged_idx[0]:
        k = r.key_pool[j]
        want = max(1000 - hits[j], 0)
        if k not in slot:
            ways = host["key"][(k & (nb - 1)) * 8:][:8]
            assert per_bucket[k & (nb - 1)] > INSERT_ROUNDS
            assert ways.all() and not (ways == k).any()
            counts["missing"] += 1
            continue
        s = slot[k]
        got = (host["remaining_f"][s] if host["algo"][s] == 1
               else host["remaining"][s])
        if per_bucket[k & (nb - 1)] <= INSERT_ROUNDS:
            assert got == want
            counts["small"] += 1
        else:
            assert want <= got <= 999
            counts["found"] += 1
    assert counts["small"] > 0
    if n_keys == 3000:  # 18% load: nothing evicted
        assert len(slot) == n_keys and counts["missing"] == 0
    else:  # the bench's load: full buckets evicted pool keys
        assert len(slot) < n_keys and counts["found"] > 0


def test_cpu_run_line_has_the_jax_key_set(small_run):
    line = small_run.line
    assert set(line) == JAX_LINE_KEYS, set(line) ^ JAX_LINE_KEYS
    assert line["metric"] == "rate_limit_decisions_per_sec_per_chip_10M_keys"
    assert line["value"] > 0 and line["fed_decisions_per_sec"] > 0
    assert line["fed_batch"] == 64
    assert line["fed_link_bytes_per_decision"] == 168
    assert small_run.claim is None  # the plain path takes no claim words


@pytest.mark.parametrize("num_slots", [1 << 12, 1 << 14])
def test_populate_and_kernel_step_responses_bit_exact(num_slots):
    """A populate dispatch of several rounds, then staged one-round steps
    (with repeats, so rows are found and spent), through the bench's
    stepper: responses and table equal JAX apply_batch_impl's."""
    batch, now = 128, bench.NOW0
    pool = np.random.default_rng(num_slots).integers(
        1, 1 << 63, size=600, dtype=np.int64)
    chunks = np.zeros((5, batch), dtype=np.int64)
    chunks.ravel()[:600] = pool
    step = bench._Stepper(CPU, num_slots, 5, batch)
    table = init_table(num_slots, CPU)
    qs = torch.stack([bench.batch_from_keys(torch.from_numpy(c))
                      for c in chunks])
    table, resps = step(table, qs, torch.full((5,), now, dtype=torch.int64))
    jt = jinit_table(num_slots)
    for b, c in enumerate(chunks):
        jt, jr = _apply(jt, jax_batch_from_keys(jnp.asarray(c)),
                        jnp.int64(now), ways=8)
        np.testing.assert_array_equal(resps[b].numpy(), jax_packed(jr))
    rng = np.random.default_rng(7)
    now1 = torch.full((1,), now, dtype=torch.int64)
    for _ in range(4):
        ks = pool[rng.choice(600, size=batch, replace=False)]
        table, r = step(table, bench.batch_from_keys(
            torch.from_numpy(ks)).unsqueeze(0), now1)
        jt, jr = _apply(jt, jax_batch_from_keys(jnp.asarray(ks)),
                        jnp.int64(now), ways=8)
        np.testing.assert_array_equal(r[0].numpy(), jax_packed(jr))
        assert int((r[0, 5] != 0).sum()) == batch  # every key found
    assert_tables_equal(jt, table_to_host(table))


def test_fed_round_bit_exact_via_stepper_and_backend_launch():
    """The fed metric's host-packed round, uploaded each step: through the
    bench's stepper and through TorchBackend._launch (the plain path on the
    CPU), equal to JAX apply_batch_packed_q, responses and tables."""
    num_slots, width, now = 1 << 12, 64, bench.NOW0
    ks = np.random.default_rng(3).integers(1, 1 << 63, size=48,
                                           dtype=np.int64)
    q = bench.pack_q(ks, width)
    step = bench._Stepper(CPU, num_slots, 1, width)
    table = init_table(num_slots, CPU)
    be = TorchBackend(DeviceConfig(num_slots=num_slots, batch_size=width,
                                   platform="cpu"))
    jt = jinit_table(num_slots)
    nows = np.full(1, now, dtype=np.int64)
    for _ in range(3):
        table, r = step(table, torch.from_numpy(q).unsqueeze(0),
                        torch.from_numpy(nows))
        resps, _ = be._launch(q[None], nows, 0)
        jt, jr = jstep.apply_batch_packed_q(jt, jnp.asarray(q),
                                            jnp.int64(now), ways=8)
        np.testing.assert_array_equal(r[0].numpy(), np.asarray(jr))
        np.testing.assert_array_equal(resps[0].numpy(), np.asarray(jr))
    assert_tables_equal(jt, table_to_host(table))
    assert_tables_equal(jt, table_to_host(be.table))


def test_knobs_checked_before_the_populate(monkeypatch):
    monkeypatch.setenv("BENCH_BATCH", "512")
    monkeypatch.setenv("BENCH_KEYS", "100")
    with pytest.raises(SystemExit, match="BENCH_KEYS"):
        bench.run(1 << 12, CPU)
    monkeypatch.setenv("BENCH_KEYS", "1000")
    monkeypatch.setenv("BENCH_FED_BATCH", "0")
    with pytest.raises(SystemExit, match="BENCH_FED_BATCH"):
        bench.run(1 << 12, CPU)


def test_cli_without_a_card_prints_the_skip_line_and_exits_2():
    env = {k: v for k, v in os.environ.items()
           if k != "GUBER_TPU_PLATFORM"}
    p = subprocess.run(
        [sys.executable, "-m", "gubernator_tpu_torch.cli.bench"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2, p.stderr
    out = p.stdout.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert set(line) == {"metric", "skipped", "reason"}
    assert line["skipped"] is True
    assert line["reason"].startswith("device_unavailable: ")


def test_main_exits_1_on_a_failed_or_partial_fed_phase(monkeypatch, capsys):
    """The line is printed, labeled, whatever the fed phase did; the exit
    code is 0 only when both metrics completed."""
    monkeypatch.setenv("GUBER_TPU_PLATFORM", "cpu")
    for extra, rc in (({}, 0), ({"fed_error": "RuntimeError: x"}, 1),
                      ({"fed_partial": "fed budget expired"}, 1)):
        line = bench.metric_line(1.0, **extra)
        monkeypatch.setattr(bench, "run", lambda *a, line=line: bench.BenchRun(
            line, None, None, None, None, [], bench.NOW0))
        assert bench.main() == rc
        assert json.loads(capsys.readouterr().out) == line
