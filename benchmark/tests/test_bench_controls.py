"""The check's control and its faults, at a size a CPU test holds.

- The control: a run whose answers, once the window has closed, are the
  plain reference's in the next precision below the one the configuration
  states (the exact tier's leaky arithmetic in float32 for float64; the
  sketch's estimate in bfloat16 for float32), in the program's place, has
  to come out with `correct` false through the run's own verdict.
- The faults: a run driven end to end with the timed path broken
  underneath (a step that leaves its state unchanged, half of each call
  left out, an answer altered where it is produced) has to come out with
  `correct` false.  A cell on one card has no exchange between chips.

On the card the control runs at the cells' own sizes through
`python3 benchmark/control.py`.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.tests.test_bench_harness import (  # noqa: E402
    SEED, TINY, run_tiny)

EXACT = ("exact10m-uniform-b1000+full-width", "exact10m-uniform-b1000")
SKETCH = "sketch100m-uniform-b32768"


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_fails(workload, seed):
    res = run_tiny(workload, seed=seed, control=True)
    assert res["correct"] is False, res["compared"]
    assert res["attempted"] > 0


# -- faults planted under the exact engine ---------------------------------

def _exact_fault(kind):
    from gubernator_tpu_torch.runtime import backend

    real = backend.persistent_serve_step

    def broken(table, qs, nows, seq, ways=8, claim=None, scratch=None):
        if kind == "half":
            qs = qs.clone()
            qs[:, 10, qs.shape[2] // 2:] = 0
        if kind == "unchanged":
            copy = type(table)(*(c.clone() for c in table))
            _, resps, seq2 = real(copy, qs, nows, seq, ways, claim, scratch)
            return table, resps, seq2
        table, resps, seq2 = real(table, qs, nows, seq, ways, claim, scratch)
        if kind == "altered":
            resps = resps.clone()
            resps[:, 2, ::7] += 1
        return table, resps, seq2

    return backend, "persistent_serve_step", broken


def _sketch_fault(kind):
    from gubernator_tpu_torch.ops.kernels import cms_kernel

    real = cms_kernel.cms_multi_step

    def broken(state, kh, hits, lim, now):
        if kind == "half":
            kh = kh.clone()
            kh[kh.shape[0] // 2:] = 0
        new_state, packed = real(state, kh, hits, lim, now)
        if kind == "unchanged":
            return state, packed
        if kind == "altered":
            packed = packed.clone()
            packed[:, 1, ::7] += 1
        return new_state, packed

    return cms_kernel, "cms_multi_step", broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_fault_makes_the_run_incorrect(workload, kind, monkeypatch):
    plant = _sketch_fault if workload == SKETCH else _exact_fault
    monkeypatch.setattr(*plant(kind))
    res = run_tiny(workload)
    assert res["correct"] is False, res["compared"]


def test_sound_run_is_correct_over_seeds():
    for seed in range(3):
        for workload in sorted(TINY):
            res = run_tiny(workload, seed=seed, seconds=0.3)
            assert res["correct"] is True, (workload, seed, res["compared"])


def test_fault_plants_reach_the_timed_path(monkeypatch):
    calls = []
    mod, name, broken = _exact_fault("none")

    def spy(*a, **k):
        calls.append(1)
        return broken(*a, **k)

    monkeypatch.setattr(mod, name, spy)
    run_tiny(EXACT[0], seconds=0.2)
    assert calls
