"""Key fingerprints: XXH64 (seed 0) of the UTF-8 hash key.

The slot table stores a 64-bit fingerprint per key; 0 is the empty-slot
sentinel, so a key whose XXH64 is 0 is remapped to 1.  The hash is
implemented here (no `xxhash` dependency): `key_hash64` in plain Python for
one key, `bulk_key_hash64` vectorised with numpy over a batch, grouping the
keys by byte length so every XXH64 step is one array operation over the
group.  Both follow the XXH64 specification (xxhash.com, XXH64 algorithm
description) and are held equal to the `xxhash` package by the tests.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

_M64 = 0xFFFFFFFFFFFFFFFF
P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * P2) & _M64
    return (_rotl(acc, 31) * P1) & _M64


def _merge(h: int, v: int) -> int:
    h ^= _round(0, v)
    return (h * P1 + P4) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` as an unsigned 64-bit int."""
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + P1 + P2) & _M64
        v2 = (seed + P2) & _M64
        v3 = seed & _M64
        v4 = (seed - P1) & _M64
        while p + 32 <= n:
            v1 = _round(v1, int.from_bytes(data[p:p + 8], "little"))
            v2 = _round(v2, int.from_bytes(data[p + 8:p + 16], "little"))
            v3 = _round(v3, int.from_bytes(data[p + 16:p + 24], "little"))
            v4 = _round(v4, int.from_bytes(data[p + 24:p + 32], "little"))
            p += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = _merge(h, v)
    else:
        h = (seed + P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * P1 + P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * P1) & _M64
        h = (_rotl(h, 23) * P2 + P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * P5) & _M64
        h = (_rotl(h, 11) * P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * P2) & _M64
    h ^= h >> 29
    h = (h * P3) & _M64
    h ^= h >> 32
    return h


def key_hash64(key: str) -> int:
    """64-bit device fingerprint of a hash key (unsigned); never 0."""
    h = xxh64(key.encode())
    return h if h != 0 else 1


# -- numpy form: one key length at a time, every step over the group ------

_U = np.uint64


def _vrotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U(r)) | (x >> _U(64 - r))


def _vround(acc: np.ndarray, lane: np.ndarray) -> np.ndarray:
    return _vrotl(acc + lane * _U(P2), 31) * _U(P1)


def _xxh64_same_len(mat: np.ndarray) -> np.ndarray:
    """XXH64 (seed 0) of each row of a uint8[n, L] matrix."""
    n, length = mat.shape
    pad = (-length) % 8
    padded = np.zeros((n, length + pad), dtype=np.uint8)
    padded[:, :length] = mat
    words = padded.view("<u8")  # [n, ceil(L/8)] little-endian lanes
    p = 0
    if length >= 32:
        v = [np.full(n, x, dtype=np.uint64) for x in
             ((P1 + P2) & _M64, P2, 0, (-P1) & _M64)]
        while p + 32 <= length:
            for j in range(4):
                v[j] = _vround(v[j], words[:, p // 8 + j])
            p += 32
        h = _vrotl(v[0], 1) + _vrotl(v[1], 7) + _vrotl(v[2], 12) \
            + _vrotl(v[3], 18)
        for x in v:
            h = h ^ _vround(np.zeros(n, dtype=np.uint64), x)
            h = h * _U(P1) + _U(P4)
    else:
        h = np.full(n, P5, dtype=np.uint64)
    h = h + _U(length)
    while p + 8 <= length:
        h = h ^ _vround(np.zeros(n, dtype=np.uint64), words[:, p // 8])
        h = _vrotl(h, 27) * _U(P1) + _U(P4)
        p += 8
    if p + 4 <= length:
        w = (mat[:, p].astype(np.uint64)
             | (mat[:, p + 1].astype(np.uint64) << _U(8))
             | (mat[:, p + 2].astype(np.uint64) << _U(16))
             | (mat[:, p + 3].astype(np.uint64) << _U(24)))
        h = h ^ (w * _U(P1))
        h = _vrotl(h, 23) * _U(P2) + _U(P3)
        p += 4
    while p < length:
        h = h ^ (mat[:, p].astype(np.uint64) * _U(P5))
        h = _vrotl(h, 11) * _U(P1)
        p += 1
    h = h ^ (h >> _U(33))
    h = h * _U(P2)
    h = h ^ (h >> _U(29))
    h = h * _U(P3)
    return h ^ (h >> _U(32))


def bulk_key_hash64(keys: Sequence[str]) -> np.ndarray:
    """int64 fingerprints (two's-complement view of the uint64) of `keys`,
    0 remapped to 1."""
    enc = [k.encode() for k in keys]
    out = np.empty(len(enc), dtype=np.uint64)
    by_len: Dict[int, List[int]] = {}
    for i, e in enumerate(enc):
        by_len.setdefault(len(e), []).append(i)
    for length, idx in by_len.items():
        blob = b"".join(enc[i] for i in idx)
        mat = np.frombuffer(blob, dtype=np.uint8).reshape(len(idx), length)
        out[np.asarray(idx, dtype=np.int64)] = _xxh64_same_len(mat)
    out[out == 0] = 1
    return out.view(np.int64)


# -- the consistent-hash peer ring's string hashes ----------------------
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def fnv1_64(data: bytes) -> int:
    """FNV-1 64-bit (multiply then xor) — fasthash/fnv1.HashString64
    (reference replicated_hash.go:26,33)."""
    h = _FNV_OFFSET
    for b in data:
        h = (h * _FNV_PRIME) & _M64
        h ^= b
    return h


def fnv1a_64(data: bytes) -> int:
    """FNV-1a 64-bit (xor then multiply) — fasthash/fnv1a.HashString64."""
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _M64
    return h
