"""TorchBackend (gubernator_tpu_torch/runtime/backend.py) on the CPU as a
third engine over the behaviour table of tests/test_algorithms.py (the
reference's functional_test.go cases), plus the engine-level cases of that
file: validation errors and duplicate keys across rounds."""
from __future__ import annotations

import pytest
import torch

import test_algorithms as algo_table

from gubernator_tpu.core.types import RateLimitReq
from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.runtime.backend import TorchBackend


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small, so torch's thread pool gains nothing; one
    pool per test worker would oversubscribe the CPU that the other
    workers' timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def torch_backend(num_slots, batch_size, clock) -> TorchBackend:
    return TorchBackend(
        DeviceConfig(num_slots=num_slots, ways=8, batch_size=batch_size,
                     platform="cpu"),
        clock=clock,
    )


# -- the behaviour table (functional_test.go cases) -----------------------

SCENARIOS = [
    algo_table.test_token_bucket,
    algo_table.test_token_bucket_gregorian,
    algo_table.test_token_bucket_negative_hits,
    algo_table.test_leaky_bucket,
    algo_table.test_leaky_bucket_with_burst,
    algo_table.test_change_limit,
    algo_table.test_reset_remaining,
    algo_table.test_leaky_bucket_div_bug,
    algo_table.test_token_bucket_over_limit_first_hit,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_behaviour_table(scenario, frozen_clock):
    scenario(torch_backend(1024, 64, frozen_clock), frozen_clock)


def test_validation_errors(frozen_clock):
    be = torch_backend(256, 16, frozen_clock)
    resps = be.check([
        RateLimitReq(name="", unique_key="k", limit=1, hits=1),
        RateLimitReq(name="n", unique_key="", limit=1, hits=1),
        RateLimitReq(name="n", unique_key="k", limit=5, hits=1, duration=1000),
    ])
    assert "name" in resps[0].error
    assert "unique_key" in resps[1].error
    assert resps[2].error == "" and resps[2].remaining == 4


def test_duplicate_keys_in_batch(frozen_clock):
    be = torch_backend(256, 16, frozen_clock)
    reqs = [RateLimitReq(name="dup", unique_key="k", limit=10, hits=1,
                         duration=60_000) for _ in range(5)]
    assert [r.remaining for r in be.check(reqs)] == [9, 8, 7, 6, 5]


def test_duplicate_keys_batch_overflow(frozen_clock):
    be = torch_backend(256, 2, frozen_clock)
    reqs = [RateLimitReq(name="of", unique_key=k, limit=10, hits=1,
                         duration=60_000) for k in "abccc"]
    assert [r.remaining for r in be.check(reqs)] == [9, 9, 9, 8, 7]
    assert be.checks == 5
