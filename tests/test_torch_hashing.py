"""The torch port's own XXH64 (gubernator_tpu_torch/core/hashing.py) against
the `xxhash` package and the JAX package's fingerprints: seeded ASCII,
unicode, empty and long keys, every length across the XXH64 stripe and
tail boundaries, and the 0 -> 1 remap."""
from __future__ import annotations

import numpy as np
import pytest
import xxhash

from gubernator_tpu.core.hashing import key_hash64 as jax_key_hash64
from gubernator_tpu_torch.core import hashing


def _keys(kind: str, rng: np.random.Generator, n: int = 400):
    if kind == "ascii":
        return ["".join(chr(c) for c in rng.integers(32, 127, rng.integers(1, 40)))
                for _ in range(n)]
    if kind == "unicode":
        return ["".join(chr(c) for c in rng.integers(0xA0, 0x3000, rng.integers(1, 30)))
                for _ in range(n)]
    if kind == "lengths":  # every byte length 0..130: stripes and tails
        return ["x" * n_ for n_ in range(131)]
    if kind == "long":
        return ["k" * int(rng.integers(200, 3000)) + str(i) for i in range(20)]
    return [""]


KINDS = ["ascii", "unicode", "lengths", "long", "empty"]


@pytest.mark.parametrize("kind", KINDS)
def test_xxh64_matches_xxhash(kind):
    rng = np.random.default_rng(7)
    for key in _keys(kind, rng):
        want = xxhash.xxh64_intdigest(key)
        assert hashing.xxh64(key.encode()) == want, repr(key)
        assert hashing.key_hash64(key) == (want or 1)
        assert hashing.key_hash64(key) == jax_key_hash64(key)


@pytest.mark.parametrize("kind", KINDS)
def test_bulk_matches_scalar(kind):
    rng = np.random.default_rng(11)
    keys = _keys(kind, rng)
    want = np.array(
        [hashing.key_hash64(k) for k in keys], dtype=np.uint64
    ).view(np.int64)
    got = hashing.bulk_key_hash64(keys)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_zero_fingerprint_remaps_to_one(monkeypatch):
    """0 is the empty-slot sentinel: a key hashing to 0 is stored as 1."""
    monkeypatch.setattr(hashing, "xxh64", lambda data, seed=0: 0)
    assert hashing.key_hash64("anything") == 1
    monkeypatch.setattr(
        hashing, "_xxh64_same_len",
        lambda mat: np.zeros(mat.shape[0], dtype=np.uint64),
    )
    np.testing.assert_array_equal(
        hashing.bulk_key_hash64(["a", "bb", "a"]), np.ones(3, dtype=np.int64)
    )
