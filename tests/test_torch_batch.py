"""The torch port's request packer against gubernator_tpu.ops.batch:
array-equal rounds, identical positions and errors, on the same requests
and the same frozen clock."""
from __future__ import annotations

import random

import numpy as np
import pytest

import gubernator_tpu.core.types as jt
import gubernator_tpu_torch.core.types as tt
from gubernator_tpu.ops.batch import pack_requests as jax_pack
from gubernator_tpu_torch.ops.batch import pack_batch_q, pack_requests


def _spec(rng: random.Random, n_keys: int):
    """One request as a plain tuple, built into either package's type."""
    behavior = 0
    if rng.random() < 0.1:
        behavior |= 8  # RESET_REMAINING
    greg = rng.random() < 0.15
    if greg:
        behavior |= 4  # DURATION_IS_GREGORIAN
    duration = rng.choice([0, 1, 2, 3, 4, 5, 7]) if greg else rng.choice(
        [5, 1000, 60_000])
    name = rng.choice(["a", "b", ""]) if rng.random() < 0.05 else "n"
    key = "" if rng.random() < 0.03 else f"k{rng.randrange(n_keys)}"
    return (name, key, rng.choice([0, 1, 2, -1, 100]),
            rng.choice([0, 1, 10, 1000]), duration, rng.randrange(2),
            behavior, rng.choice([0, 0, 20]))


def _build(mod, specs):
    return [
        mod.RateLimitReq(
            name=n, unique_key=k, hits=h, limit=lim, duration=d,
            algorithm=mod.Algorithm(a), behavior=mod.Behavior(b), burst=bu,
        )
        for n, k, h, lim, d, a, b, bu in specs
    ]


def _assert_same(specs, batch_size, clock, use_cached=None):
    want = jax_pack(_build(jt, specs), batch_size, clock, use_cached)
    got = pack_requests(_build(tt, specs), batch_size, clock, use_cached)
    assert got.errors == want.errors
    assert got.positions == want.positions
    assert len(got.rounds) == len(want.rounds)
    for g, w in zip(got.rounds, want.rounds):
        for f, a, b in zip(w._fields, g, w):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    return got


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_random_batches_match(seed, frozen_clock):
    rng = random.Random(seed)
    for _ in range(6):
        specs = [_spec(rng, 30) for _ in range(rng.randrange(1, 120))]
        cached = [rng.random() < 0.3 for _ in specs]
        _assert_same(specs, 64, frozen_clock, cached)


def test_validation_errors_take_no_lane(frozen_clock):
    specs = [
        ("", "k", 1, 1, 1000, 0, 0, 0),
        ("n", "", 1, 1, 1000, 0, 0, 0),
        ("n", "k", 1, 5, 3, 0, 4, 0),   # Gregorian weeks: unsupported
        ("n", "k", 1, 5, 9, 0, 4, 0),   # not a Gregorian interval
        ("n", "k", 1, 5, 1000, 0, 0, 0),
    ]
    got = _assert_same(specs, 8, frozen_clock)
    assert set(got.errors) == {0, 1, 2, 3}
    assert got.positions[4] == (0, 0)


def test_gregorian_intervals(frozen_clock):
    specs = [("g", f"k{d}", 1, 60, d, 0, 4, 0) for d in (0, 1, 2, 4, 5)]
    got = _assert_same(specs, 8, frozen_clock)
    db = got.rounds[0]
    assert db.is_greg[:5].all() and (db.greg_expire[:5] > 0).all()


def test_duplicates_span_rounds(frozen_clock):
    specs = [("d", f"k{i % 3}", 1, 10, 1000, i % 2, 0, 0) for i in range(10)]
    got = _assert_same(specs, 16, frozen_clock)
    assert len(got.rounds) == 4  # k0 occurs 4 times


def test_batch_overflow(frozen_clock):
    specs = [("o", k, 1, 10, 1000, 0, 0, 0) for k in "abccc" + "defgh"]
    got = _assert_same(specs, 2, frozen_clock)
    for db in got.rounds:
        keys = db.key_hash[db.active]
        assert len(set(keys.tolist())) == len(keys)


def test_pack_batch_q_row_order(frozen_clock):
    specs = [("q", "k", 3, 10, 1000, 1, 8, 20)]
    got = pack_requests(_build(tt, specs), 4, frozen_clock, [True])
    q = pack_batch_q(got.rounds[0])
    assert q.dtype == np.int64 and q.shape == (12, 4)
    assert q[1:12, 0].tolist() == [3, 10, 1000, 1, 20, 1, 0, 0, 0, 1, 1]
