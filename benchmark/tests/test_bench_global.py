"""CPU tests of the GLOBAL cell (`global-mesh4-zipf`) at a tiny size: the
cell end to end, traced and not; the traffic's seeding; the check's control
on 3 seeds; faults planted under the engine (one owner's broadcast dropped
between cards, half of a call left out, answers altered) reading false; and
the GLOBAL yardstick's byte count by hand.

    python -m pytest benchmark/tests/test_bench_global.py -q
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import global_yardstick as gy  # noqa: E402
from benchmark import harness, yardstick  # noqa: E402
from benchmark.global_traffic import ZipfPool  # noqa: E402
from benchmark.tests.test_bench_harness import KEYS, SEED  # noqa: E402

CELL = "global-mesh4-zipf"
# 256 replica buckets of 8 ways for 3000 keys and 128 authoritative ones a
# shard: both kinds of bucket overfill; 64 delta slots: syncs take chunks.
TINY = {"config": {"keys": 3000, "deployment": {"delta_slots": 64},
                   "device": {"num_slots": 4096, "global_cache_slots": 8192,
                              "batch_size": 512}},
        "traffic": {"pool_calls": 16,
                    "check": {"pairs": 48, "overfull_share": 0.25,
                              "hot_keys": 4}}}


def run_tiny(trace=False, seconds=0.6, seed=SEED, control=False):
    return harness.run_cell(CELL, seed, seconds, trace, device="cpu",
                            overrides=TINY, control=control,
                            log=lambda s: None)


def tiny_inputs():
    cell = harness.Cell(harness.load_spec(), CELL)
    return (harness._merge(cell.config, TINY["config"]),
            harness._merge(cell.traffic, TINY["traffic"]))


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_end_to_end(trace):
    # A traced window long enough for calls after its untraced 40%.
    res = run_tiny(trace, seconds=4.0 if trace else 0.6)
    line = json.loads(json.dumps(res))
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] > 0 and line["attempted"] % 1000 == 0
    assert set(line["compared"]) == {"answers_wrong", "replica_rows_wrong",
                                     "auth_rows_wrong"}
    cell = harness.Cell(harness.load_spec(), CELL)
    wanted = cell.per_layer if trace else cell.end_to_end
    host_only = {m["name"] for m in wanted if m["source"] == "host_clock"}
    assert host_only <= set(line["metrics"])
    assert set(line["metrics"]) <= {m["name"] for m in wanted}
    for m in line["metrics"].values():
        assert m["value"] > 0
    if trace:
        assert 0 < line["metrics"]["lane_fill.global"]["value"] <= 100


def test_same_seed_same_calls():
    config, mix = tiny_inputs()
    a, b = (ZipfPool(mix, config, SEED) for _ in range(2))
    c = ZipfPool(mix, config, SEED + 1)
    for f in ("pool", "limit", "duration", "algo", "populate_order",
              "key_of_rank"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert not np.array_equal(a.pool, c.pool)
    assert a.pool.shape == c.pool.shape == (16, 1000)
    assert a.hash_keys() == b.hash_keys() != c.hash_keys()
    # Zipf 0.99 over 3000 keys: the hottest key takes about 1/8.6 of the
    # checks, a uniform draw 1/3000.
    top = np.mean(a.pool == a.key_of_rank[0])
    assert 0.08 < top < 0.16
    assert np.array_equal(np.sort(a.populate_order), np.arange(3000))


@pytest.mark.parametrize("seed", [SEED, SEED + 1, 2**33 + 5])
def test_control_fails(seed):
    res = run_tiny(seed=seed, control=True)
    assert res["correct"] is False, res["compared"]
    assert res["attempted"] > 0


def _fault(kind):
    from gubernator_tpu_torch.parallel import global_sync

    if kind == "broadcast":
        real = global_sync.GlobalEngine._all_gather

        def broken(self, rows):
            out = real(self, rows)
            out[1] = out[1].clone()
            out[1][0, :rows[0].shape[1]] = 0  # card 1 misses owner 0's rows
            return out

        return global_sync.GlobalEngine, "_all_gather", broken
    if kind == "half":
        real = global_sync.GlobalEngine.serve_packed

        def broken(self, rounds, pend_items):
            for db in rounds:
                db.active[: self.n // 2] = False
            return real(self, rounds, [p for p in pend_items
                                       if p[2] >= self.n // 2])

        return global_sync.GlobalEngine, "serve_packed", broken
    real = global_sync.packed_grid_rounds_to_host

    def broken(resps):
        host = real(resps)
        if host:
            host[0]["remaining"] = host[0]["remaining"].copy()
            host[0]["remaining"][:, ::7] += 1
        return host

    return global_sync, "packed_grid_rounds_to_host", broken


@pytest.mark.parametrize("kind", ["broadcast", "half", "altered"])
def test_fault_makes_the_run_incorrect(kind, monkeypatch):
    monkeypatch.setattr(*_fault(kind))
    res = run_tiny()
    assert res["correct"] is False, res["compared"]


def test_global_yardstick_by_hand():
    # Keys in a sync's chunks: an owner's first 256 keys in chunk 0.
    assert gy.chunk_keys([300, 10, 256, 0], 256) == [522, 44]
    assert gy.chunk_keys([0, 0], 64) == []
    # One chunk of 3 keys, 2 cards, 4 delta slots, 8 ways: the grid
    # 72 B x 2 x 2 x 4 = 1152; the two rounds 16 + 6 lanes x (96 + 72 +
    # 192) + 3 found x 60 + 3 written x 84 = 2608; each of 2 replicas
    # 3 x (48 + 192 + 84) = 972.
    assert gy.sync_bytes([3], 2, 4, 8) == 1152 + 2608 + 2 * 972
    assert yardstick.useful_bytes(2, 6, 3, 3, 8) == 2608
