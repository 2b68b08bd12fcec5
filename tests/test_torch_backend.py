"""TorchBackend (gubernator_tpu_torch/runtime/backend.py) on the CPU against
gubernator_tpu's DeviceBackend: the random, eviction and zipfian-duplicate
streams of tests/test_differential.py run side by side on the same requests
and the same frozen clock, with identical responses and tables; the
snapshot handover between the two engines; the columnar entry points; and
the refusal to run on a CUDA device that is not there.  The behaviour table
is in tests/test_torch_algorithms.py."""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from test_differential import _random_req

from gubernator_tpu.core.config import DeviceConfig as JaxDeviceConfig
from gubernator_tpu.core.types import Algorithm, RateLimitReq
from gubernator_tpu.ops.batch import pack_requests as jax_pack
from gubernator_tpu.runtime.backend import DeviceBackend
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


def torch_backend(num_slots, batch_size, clock, **kw) -> TorchBackend:
    return TorchBackend(
        DeviceConfig(num_slots=num_slots, ways=8, batch_size=batch_size,
                     platform="cpu", **kw),
        clock=clock,
    )


def jax_backend(num_slots, batch_size, clock) -> DeviceBackend:
    return DeviceBackend(
        JaxDeviceConfig(num_slots=num_slots, ways=8, batch_size=batch_size),
        clock=clock,
    )


def resp_key(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


def assert_same_responses(got, want, ctx=""):
    assert [resp_key(r) for r in got] == [resp_key(r) for r in want], ctx


def assert_same_tables(tb: TorchBackend, jb: DeviceBackend):
    t, j = tb.snapshot(), jb.snapshot()
    for f in j:
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)


# -- the differential streams, side by side with DeviceBackend ------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_stream_matches_device_backend(seed, frozen_clock):
    rng = random.Random(seed)
    jb = jax_backend(2048, 64, frozen_clock)
    tb = torch_backend(2048, 64, frozen_clock)
    for step in range(60):
        batch = [_random_req(rng, 40) for _ in range(rng.randrange(1, 48))]
        assert_same_responses(tb.check(batch), jb.check(batch), f"step={step}")
        frozen_clock.advance(rng.choice([0, 1, 500, 3_000, 61_000]))
    assert_same_tables(tb, jb)


def test_eviction_stream_matches_device_backend(frozen_clock):
    jb = jax_backend(32, 64, frozen_clock)
    tb = torch_backend(32, 64, frozen_clock)
    for round_i in range(6):
        reqs = [
            RateLimitReq(name="evict", unique_key=f"k:{i}", limit=10, hits=1,
                         duration=60_000)
            for i in range(round_i * 40, round_i * 40 + 40)
        ]
        got = tb.check(reqs)
        assert_same_responses(got, jb.check(reqs), f"round={round_i}")
        assert all(r.error == "" and r.remaining == 9 for r in got)
    assert tb.occupancy() == jb.occupancy() <= 32
    assert_same_tables(tb, jb)


def test_zipfian_duplicates_match_device_backend(frozen_clock):
    rng = random.Random(11)
    jb = jax_backend(2048, 64, frozen_clock)
    tb = torch_backend(2048, 64, frozen_clock)
    for step in range(20):
        batch = [
            RateLimitReq(
                name="zipf",
                unique_key=f"z{min(int(rng.paretovariate(0.8)), 30)}",
                hits=rng.choice([0, 1, 1, 1, 2]),
                limit=500,
                duration=60_000,
                algorithm=rng.choice(
                    [Algorithm.TOKEN_BUCKET, Algorithm.LEAKY_BUCKET]),
                burst=rng.choice([0, 0, 600]),
            )
            for _ in range(rng.randrange(10, 60))
        ]
        assert_same_responses(tb.check(batch), jb.check(batch), f"step={step}")
        frozen_clock.advance(rng.choice([0, 0, 250, 2_000]))
    assert_same_tables(tb, jb)


def test_snapshot_handover(frozen_clock):
    """Run a stream on the JAX engine, move its table into the port, and
    continue both: they stay identical (and the reverse direction)."""
    rng = random.Random(21)
    jb = jax_backend(2048, 64, frozen_clock)
    for _ in range(15):
        jb.check([_random_req(rng, 40) for _ in range(rng.randrange(1, 48))])
        frozen_clock.advance(rng.choice([0, 500, 3_000]))
    tb = torch_backend(2048, 64, frozen_clock)
    tb._install_table(jb.snapshot())
    assert_same_tables(tb, jb)
    for step in range(15):
        batch = [_random_req(rng, 40) for _ in range(rng.randrange(1, 48))]
        assert_same_responses(tb.check(batch), jb.check(batch), f"step={step}")
        frozen_clock.advance(rng.choice([0, 500, 3_000]))
    back = jax_backend(2048, 64, frozen_clock)
    back._install_table(tb.snapshot())
    batch = [_random_req(rng, 40) for _ in range(40)]
    assert_same_responses(tb.check(batch), back.check(batch))
    with pytest.raises(ValueError, match="slots"):
        torch_backend(1024, 64, frozen_clock)._install_table(jb.snapshot())


def test_step_rounds_and_persistent_dispatch(frozen_clock):
    """The columnar entry points: step_rounds matches DeviceBackend's (the
    port answers every round at the launch's widest tier), and
    persistent_serve_dispatch advances the sequence word."""
    rng = random.Random(5)
    jb = jax_backend(2048, 64, frozen_clock)
    tb = torch_backend(2048, 64, frozen_clock, batch_tiers=(8, 64))
    for _ in range(4):
        batch = [_random_req(rng, 12) for _ in range(rng.randrange(1, 40))]
        rounds = jax_pack(batch, 64, frozen_clock).rounds
        want = jb.step_rounds(rounds)
        got = tb.step_rounds_begin(rounds)()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for col, v in w.items():
                np.testing.assert_array_equal(
                    v, g[col][..., : v.shape[-1]], err_msg=col)
        frozen_clock.advance(700)
    assert tb.checks == jb.checks and tb.over_limit == jb.over_limit
    seq = tb.ring_seq_init()
    qs = np.zeros((3, 12, 8), dtype=np.int64)
    resps, seq = tb.persistent_serve_dispatch(qs, np.zeros(3, np.int64), seq)
    assert tuple(resps.shape) == (3, 9, 8) and int(seq) == 3
    assert not resps.any()  # all-inactive rounds are no-ops


def test_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend(DeviceConfig())
