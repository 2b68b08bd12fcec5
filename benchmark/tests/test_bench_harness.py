"""CPU tests of the benchmark: every cell end to end at a tiny size, the
traffic's seeding, the yardstick's byte counts by hand, the harness's
imports, and that a new configuration, traffic mix and metric are new
files only.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import generator, harness, yardstick  # noqa: E402

EXACT_TINY = {
    "config": {"keys": 3000,
               "device": {"num_slots": 4096, "ways": 8, "batch_size": 256}},
    "traffic": {"lanes_per_call": 256, "populate_lanes_per_call": 256,
                "check": {"buckets": 48, "overfull_share": 0.5},
                "reset_share": 0.02},
}
NARROW_TINY = {
    "config": EXACT_TINY["config"],
    "traffic": {"lanes_per_call": 100, "populate_lanes_per_call": 256,
                "check": {"buckets": 48, "overfull_share": 0.5}},
}
SKETCH_TINY = {
    "config": {"sketch": {"width": 1024, "batch_size": 64}},
    "traffic": {"lanes_per_call": 256, "pool_calls": 8, "warm_calls": 8,
                "roll_after_calls": 5, "sample_lanes_per_call": 8,
                "limits": [1, 8]},
}
# Each case is a workload of BENCHMARK.json at a tiny size; a name after
# "+" tells two sizes of one workload apart ("full-width": every lane of
# the round carries a request, as a saturated node's rounds do).
TINY = {
    "exact10m-uniform-b1000+full-width": EXACT_TINY,
    "sketch100m-uniform-b32768": SKETCH_TINY,
    "exact10m-uniform-b1000": NARROW_TINY,
}
SEED = 2**31 + 977
KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


def workload_of(case):
    return case.split("+")[0]


def run_tiny(case, trace=False, seconds=0.6, seed=SEED, root=ROOT,
             control=False):
    return harness.run_cell(workload_of(case), seed, seconds, trace,
                            root=root, device="cpu", overrides=TINY[case],
                            control=control, log=lambda s: None)


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_end_to_end(workload, trace):
    res = run_tiny(workload, trace)
    workload = workload_of(workload)
    line = json.loads(json.dumps(res))
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    spec = harness.load_spec()
    cell = harness.Cell(spec, workload)
    wanted = cell.per_layer if trace else cell.end_to_end
    host_only = {m["name"] for m in wanted if m["source"] == "host_clock"}
    assert host_only <= set(line["metrics"])
    assert set(line["metrics"]) <= {m["name"] for m in wanted}
    for m in line["metrics"].values():
        assert m["value"] > 0
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", sorted(TINY))
def test_same_seed_same_calls(workload):
    cell = harness.Cell(harness.load_spec(), workload_of(workload))
    config = harness._merge(cell.config, TINY[workload]["config"])
    mix = harness._merge(cell.traffic, TINY[workload]["traffic"])
    a, b = (generator.generate(mix, config, SEED) for _ in range(2))
    c = generator.generate(mix, config, SEED + 1)
    assert np.array_equal(a.key_hash, b.key_hash)
    assert np.array_equal(a.limit, b.limit)
    assert not np.array_equal(a.key_hash, c.key_hash)
    assert a.key_hash.shape == c.key_hash.shape
    assert (a.key_hash != 0).all()
    assert np.unique(a.key_hash).size == a.key_hash.size


def test_large_seed_gives_distinct_keys():
    import torch

    ids = torch.arange(100_000, dtype=torch.int64)
    fp = generator.fingerprints(ids, 2**33 + 5).numpy()
    assert np.unique(fp).size == ids.numel() and (fp != 0).all()


def test_fingerprints_are_the_splitmix64_finalizer():
    import torch

    seed = 2**31 + 12345
    ids = [0, 1, 2**40 + 7, 99_999_999]
    fp = generator.fingerprints(torch.tensor(ids), seed).tolist()
    off = seed * generator.GOLDEN
    want = [generator._i64(generator._fmix_int(i + off)) for i in ids]
    assert fp == want


def test_useful_bytes_by_hand():
    # One round with 3 active lanes (however wide), 2 found, 3 written,
    # 8 ways: now 8 B; 3 active x (96 request + 72 answer + 8 ways x 24)
    # = 1080; 2 found x 60 = 120; 3 written x 84 = 252.  Padding lanes
    # carry no request and count nothing.
    assert yardstick.useful_bytes(1, 3, 2, 3, 8) == 8 + 1080 + 120 + 252
    assert yardstick.useful_bytes(2, 0, 0, 0, 8) == 16


def test_sketch_useful_bytes_by_hand():
    depth, width = 2, 16
    kh = np.array([[5, 5, 0, 9]], dtype=np.int64)
    cols = yardstick.row_columns(np.array([5, 9]), depth, width)
    cells = {(d, int(c)) for d in range(depth) for c in cols[d]}
    # 4 lanes x 24 B, 12 B a distinct (row, column) of the 2 keys.
    want = 4 * 24 + 12 * len(cells)
    assert yardstick.sketch_useful_bytes(depth, width, kh, False) == want
    assert yardstick.sketch_useful_bytes(depth, width, kh, True) == \
        want + 12 * depth * width


def test_row_columns_by_hand():
    # Column = top log2(W) bits of the wrapped product.
    h = 0x0123456789ABCDEF
    for d in range(4):
        m = yardstick.ROW_MULTIPLIERS[d]
        want = ((h * m) % 2**64) >> (64 - 10)
        assert yardstick.row_columns(np.array([h]), 4, 1024)[d, 0] == want


def test_row_column_torch_matches_numpy():
    import torch

    kh = np.random.default_rng(7).integers(-2**63, 2**63 - 1, 4096,
                                           dtype=np.int64)
    for width in (1, 1024, 1 << 20):
        for d in range(4):
            want = yardstick.row_column(kh, d, width)
            got = yardstick.row_column_torch(torch.from_numpy(kh), d, width)
            assert np.array_equal(got.numpy(), want)


def test_busy_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6)]
    assert yardstick.busy_union(spans) == 4
    assert yardstick.idle_gaps(spans, 0, 8) == [(3, 5), (6, 8)]


def test_hbm_rate_only_for_the_sxm():
    assert yardstick.hbm_bytes_per_s(yardstick.SXM_NAME) == 3.35e12
    with pytest.raises(ValueError):
        yardstick.hbm_bytes_per_s("NVIDIA H100 PCIe")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_in_the_benchmark_sources():
    for path in (ROOT / "benchmark").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        for name in _imports(path):
            assert not name.startswith("gubernator_tpu"), (path, name)


def test_a_run_loads_no_jax():
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from benchmark.tests.test_bench_harness import run_tiny\n"
        "from benchmark import harness\n"
        "r = run_tiny('exact10m-uniform-b1000+full-width')\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    found, tops = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert found == []
    assert "gubernator_tpu_torch" in tops and "gubernator_tpu" not in tops


def test_command_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "exact10m-uniform-b1000", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "exact10m-uniform-b1000", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_is_new_files_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    conf = json.loads((b / "configs" / "exact_10m.json").read_text())
    conf.update(name="exact_tiny", keys=2000,
                device={"num_slots": 2048, "ways": 8, "batch_size": 128})
    (b / "configs" / "exact_tiny.json").write_text(json.dumps(conf))
    mix = json.loads((b / "traffic" / "exact_uniform_b1000.json").read_text())
    mix.update(lanes_per_call=50, populate_lanes_per_call=128,
               check={"buckets": 16, "overfull_share": 0.5})
    (b / "traffic" / "tiny_mix.json").write_text(json.dumps(mix))
    (b / "metrics" / "calls_made.py").write_text(
        "def read(ctx):\n    return float(ctx['calls'])\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "exact_tiny", "source": "a test",
                            "file": "benchmark/configs/exact_tiny.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny-cell", "config": "exact_tiny",
                              "traffic": "tiny_mix", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "calls_made", "unit": "calls",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from benchmark import harness\n"
        "assert harness.BENCH_DIR == harness.Path(%r)\n"
        "r = harness.run_cell('tiny-cell', 5, 0.5, False, device='cpu',\n"
        "                     root=harness.Path(%r), log=lambda s: None)\n"
        "print(json.dumps(r))\n"
    ) % (str(tmp_path), str(ROOT), str(b), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] is True
    assert {"decisions_per_s", "setup_s", "calls_made"} <= set(res["metrics"])
    after = _digests(b)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.cuda
def test_command_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sketch100m-uniform-b32768", "--seed", str(SEED), "--seconds", "2"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
