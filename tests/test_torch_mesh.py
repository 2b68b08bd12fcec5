"""The port's sharded table (gubernator_tpu_torch/parallel/) on the CPU
against the JAX package's mesh on conftest's virtual CPU devices.

The grid packer, shard routing and arrival spread; `MeshBackend` at 8
shards over the random streams of tests/test_differential.py, with every
response equal and `snapshot()` equal to the JAX `table_to_host` word for
word; the ring and megaround dispatches; the GLOBAL broadcast receive; the
state plane's per-shard ops on shards other than 0; the per-shard census;
and the persistent mode's decline.  Ints compare exactly, and the float64
`remaining_f` column compares exactly too.  The K1 launch on one shard's
own table is held against the plain `ring_step` on a CUDA card only; the JAX
package is imported inside the tests that compare with it, so that test
runs alone on the card's machine:
    python -m pytest --noconftest -m cuda tests/test_torch_mesh.py"""
from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest
import torch

from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.core.hashing import key_hash64
from gubernator_tpu_torch.core.types import RateLimitReq
from gubernator_tpu_torch.ops.kernels import serve_kernel
from gubernator_tpu_torch.ops.state import SHADOW_PLANES
from gubernator_tpu_torch.parallel.global_sync import arrival_dev
from gubernator_tpu_torch.parallel.mesh import shard_of_hash
from gubernator_tpu_torch.parallel.sharded import (
    MeshBackend,
    pack_grid_batch,
    pack_requests_sharded,
)

SLOTS, WAYS, B, N = 8 * 8 * 64, 8, 64, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(clock, n=N, slots=SLOTS, batch=B, **kw):
    """(port MeshBackend on the CPU, JAX MeshBackend) of one geometry."""
    from gubernator_tpu.core.config import DeviceConfig as JaxDeviceConfig
    from gubernator_tpu.parallel.sharded import MeshBackend as JaxMesh

    geo = dict(num_slots=slots, ways=WAYS, batch_size=batch, num_shards=n)
    return (MeshBackend(DeviceConfig(platform="cpu", **geo), clock=clock,
                        **kw),
            JaxMesh(JaxDeviceConfig(**geo), clock=clock, **kw))


def _random_req(rng, n_keys):
    """tests/test_differential.py's random request (imported here, so the
    card's machine, which has no JAX, can run the cuda test alone)."""
    from test_differential import _random_req as rand

    return rand(rng, n_keys)


def resp_key(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


def items(d):
    """CacheItems by key as plain tuples (the packages' classes differ)."""
    return {k: dataclasses.astuple(v) for k, v in d.items()}


def assert_same_tables(pb: MeshBackend, jb) -> None:
    got, want = pb.snapshot(), jb.snapshot()
    assert set(got) == set(want)
    for f in want:
        np.testing.assert_array_equal(got[f], np.asarray(want[f]),
                                      err_msg=f)


def reqs_on(shard: int, n_shards: int, count: int, prefix="s"):
    """`count` requests whose keys route to `shard`."""
    out, i = [], 0
    while len(out) < count:
        r = RateLimitReq(name="m", unique_key=f"{prefix}{i}", hits=1,
                         limit=10 + i % 5, duration=60_000,
                         algorithm=i % 2)
        if int(shard_of_hash(key_hash64(r.hash_key()), n_shards)) == shard:
            out.append(r)
        i += 1
    return out


@pytest.mark.parametrize("native_form", [True, False])
def test_pack_requests_grid_matches_jax(native_form, frozen_clock,
                                        monkeypatch):
    """Rounds, positions and errors of the grid packer, in its C++ and
    Python forms, equal the JAX packer's on duplicates, overflowing
    shards, validation and Gregorian errors."""
    from gubernator_tpu.parallel.sharded import (
        pack_requests_sharded as jax_pack,
    )
    from gubernator_tpu_torch import native

    rng = random.Random(3)
    reqs = [_random_req(rng, 30) for _ in range(300)]
    reqs[5] = RateLimitReq(name="", unique_key="x")
    reqs[6] = RateLimitReq(name="x", unique_key="")
    if not native_form:
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.fail("the port's native library did not build")
    got = pack_requests_sharded(reqs, 16, 4, frozen_clock,
                                use_cached=[i % 7 == 0 for i in
                                            range(len(reqs))])
    want = jax_pack(reqs, 16, 4, frozen_clock,
                    use_cached=[i % 7 == 0 for i in range(len(reqs))])
    assert got.errors == want.errors and len(got.errors) >= 2
    assert got.positions == want.positions
    assert len(got.rounds) == len(want.rounds) > 2
    for g, w in zip(got.rounds, want.rounds):
        np.testing.assert_array_equal(
            pack_grid_batch(g), np.stack([np.asarray(a) for a in w]))


def test_shard_of_hash_and_arrival_dev_match_jax():
    from gubernator_tpu.parallel.global_sync import arrival_dev as jax_arr
    from gubernator_tpu.parallel.mesh import shard_of_hash as jax_shard

    rng = np.random.default_rng(1)
    h = rng.integers(-2**63, 2**63 - 1, 500, dtype=np.int64)
    h[:3] = (0, -1, np.iinfo(np.int64).min)  # top bit set, all ones
    for n in (1, 3, 4, 8):
        np.testing.assert_array_equal(shard_of_hash(h, n),
                                      jax_shard(h, n))
        u = [int(x) for x in h.view(np.uint64)]
        assert [int(shard_of_hash(x, n)) for x in u] == \
            [int(jax_shard(x, n)) for x in u]
        assert [arrival_dev(x, n) for x in u] == [jax_arr(x, n) for x in u]
        np.testing.assert_array_equal(arrival_dev(h, n),
                                      [jax_arr(x, n) for x in u])


@pytest.mark.parametrize("seed", [1, 2])
def test_mesh_random_stream_matches_jax(seed, frozen_clock):
    """The random op-stream of test_differential_mesh_stream through both
    mesh backends at 8 shards: every response, and the whole table word
    for word (the JAX table_to_host layout, shard-major)."""
    pb, jb = pair(frozen_clock)
    pb.warmup()
    jb.warmup()
    rng = random.Random(seed)
    for step in range(30):
        batch = [_random_req(rng, 40) for _ in range(rng.randrange(1, 90))]
        got, want = pb.check(batch), jb.check(batch)
        assert [resp_key(r) for r in got] == \
            [resp_key(r) for r in want], step
        frozen_clock.advance(rng.choice([0, 0, 250, 2_000]))
    assert_same_tables(pb, jb)
    assert pb.checks == jb.checks and pb.over_limit == jb.over_limit
    assert pb.shard_occupancy() == jb.shard_occupancy()
    assert sum(pb.shard_occupancy()) == pb.occupancy() == jb.occupancy()


def test_ring_and_megaround_dispatches_match_jax(frozen_clock):
    """ring_step_dispatch on [k, 12, n, B] blocks and ring_mega_dispatch
    on [r, s, 12, n, B] blocks: responses, per-shard sequence words and
    tables equal the JAX mesh ring steps'."""
    pb, jb = pair(frozen_clock, n=4)
    rng = random.Random(4)
    now = frozen_clock.millisecond_now()
    seq_p, seq_j = pb.ring_seq_init(), jb.ring_seq_init()
    for it in range(4):
        k = 4
        packed = pack_requests_sharded(
            [_random_req(rng, 30) for _ in range(120)], B, 4, frozen_clock)
        rounds = (packed.rounds + [packed.rounds[-1]._replace(
            active=np.zeros_like(packed.rounds[-1].active))] * k)[:k]
        qs = np.stack([pb.ring_pack_round(db, B) for db in rounds])
        assert qs.shape == (k,) + pb.ring_q_shape(B) \
            == (k,) + jb.ring_q_shape(B)
        nows = np.full(k, now + it, dtype=np.int64)
        if it % 2:
            qs = qs.reshape((2, 2) + qs.shape[1:])
            nows = nows.reshape(2, 2)
            rp, seq_p = pb.ring_mega_dispatch(qs, nows, seq_p)
            rj, seq_j = jb.ring_mega_dispatch(qs, nows, seq_j)
        else:
            rp, seq_p = pb.ring_step_dispatch(qs, nows, seq_p)
            rj, seq_j = jb.ring_step_dispatch(qs, nows, seq_j)
        np.testing.assert_array_equal(rp.numpy(), np.asarray(rj))
        np.testing.assert_array_equal(seq_p.numpy(), np.asarray(seq_j))
    assert seq_p.tolist() == [16] * 4
    assert_same_tables(pb, jb)


def test_apply_cached_rows_matches_jax(frozen_clock):
    """The GLOBAL broadcast receive, routed to owner shards, with more
    rows for one shard than a grid holds (a second grid)."""
    pb, jb = pair(frozen_clock, n=4, batch=16)
    now = frozen_clock.millisecond_now()
    rows = [(r.hash_key(), r.algorithm, r.limit, i % 7, i % 2,
             now + 1000 + i) for i, r in enumerate(
                 reqs_on(2, 4, 40) + reqs_on(1, 4, 5, prefix="t"))]
    pb.apply_cached_rows(rows)
    jb.apply_cached_rows(rows)
    assert_same_tables(pb, jb)
    occ = pb.shard_occupancy()
    assert occ[2] >= 30 and occ == jb.shard_occupancy()
    for key, *_ in rows[:3] + rows[-2:]:
        assert items(pb.read_items_bulk([key], include_cached=True)) == \
            items(jb.read_items_bulk([key], include_cached=True))


def test_state_ops_on_shards_past_zero_match_jax(frozen_clock):
    """Probe, row gather, load (Loader restore), demote and the census,
    each driven on shard 3 (and shard 1): every write lands in the base
    table through the shard's views, as the JAX mesh's does."""
    pb, jb = pair(frozen_clock, n=4, batch=16, track_keys=True)
    reqs = reqs_on(3, 4, 30) + reqs_on(1, 4, 6, prefix="u")
    for b in (pb, jb):
        b.check(reqs)
    frozen_clock.advance(5)
    keys = [r.hash_key() for r in reqs] + ["m_absent"]
    hashes = [key_hash64(k) for k in keys]
    now = frozen_clock.millisecond_now()
    with pb._lock:
        fp, sp = pb._probe_grid(keys, hashes, now)
    with jb._lock:
        fj, sj = jb._probe_grid(keys, hashes, now)
    np.testing.assert_array_equal(fp, fj)
    np.testing.assert_array_equal(sp, sj)
    assert fp[:-1].all() and not fp[-1]
    assert (sp[:30] // (SLOTS // 4) == 3).all()
    assert items(pb.read_items_bulk(keys)) == items(jb.read_items_bulk(keys))
    # Loader restore into shard 3: new rows and overwrites.
    restore = [type(it)(**{**it.__dict__, "remaining": 1})
               for it in jb.live_items()[:10]]
    assert pb.load_items(restore) == jb.load_items(restore) == 10
    assert_same_tables(pb, jb)
    # Census with shadow fingerprints, then demote (shared protect list).
    fps = np.zeros((len(SHADOW_PLANES), 8), dtype=np.int64)
    fps[0, :3] = np.array(hashes[:3], dtype=np.uint64).view(np.int64)
    got, want = pb.table_stats_dispatch(fps)(), jb.table_stats_dispatch(fps)()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.occupancy[3] > 0 and got.shadow_slots[3, 0] == 3
    protect = np.array(hashes[:4], dtype=np.uint64).view(np.int64)
    dp, dj = (b.demote_extract_dispatch(protect, 5)() for b in (pb, jb))
    np.testing.assert_array_equal(dp[0], dj[0])
    np.testing.assert_array_equal(dp[1], dj[1])
    assert (dp[0][0] != 0).sum() >= 5
    assert_same_tables(pb, jb)


def test_persistent_mode_declines_as_in_jax(frozen_clock):
    """The mesh reports no persistent kernel, with the JAX reason, so the
    fast lane serves megaround; a mesh asked for CUDA without a card
    raises; geometry errors are the JAX package's."""
    pb, jb = pair(frozen_clock, n=4)
    assert pb.persistent_serve_supported() == \
        jb.persistent_serve_supported()
    assert pb.persistent_serve_supported()[0] is False
    assert not hasattr(pb, "persistent_serve_dispatch")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeshBackend(DeviceConfig(num_slots=SLOTS, num_shards=4))
    with pytest.raises(ValueError, match="ways\\*num_shards"):
        DeviceConfig(num_slots=SLOTS + 8, num_shards=4)
    with pytest.raises(ValueError, match="global_cache_slots"):
        DeviceConfig(num_slots=SLOTS, num_shards=4, global_cache_slots=40)


@pytest.mark.cuda
def test_k1_on_shard_views_matches_plain_on_cuda():
    """K1 launched on shard 2's own table and claim words of a 4-shard
    MeshBackend (S = L), on its stream, equals the plain ring_step on a
    clone of that table, bit for bit; the other shards are untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    from gubernator_tpu_torch.ops.ring import ring_step
    from gubernator_tpu_torch.ops.state import clone_table
    from gubernator_tpu_torch.testing import (
        KeySpace,
        random_rounds,
        random_table,
    )

    n, S, now = 4, 1 << 16, 1_700_000_000_000
    rng = np.random.default_rng(2)
    L = S // n
    ks = KeySpace(rng, L, 8, hot_buckets=16)
    parts = [random_table(rng, ks, now) for _ in range(n)]
    be = MeshBackend(DeviceConfig(num_slots=S, ways=8, batch_size=2048,
                                  num_shards=n),
                     devices=[torch.device("cuda", 0)])
    be._install_table({f: np.concatenate([p[f] for p in parts])
                       for f in parts[0]})
    place, kt, claim = be.shards[2], be.tables[2], be.claims[2]
    dev = place.device
    qs = torch.from_numpy(
        random_rounds(rng, ks, parts[2]["key"], 3, 2048, now)).to(dev)
    nows = torch.tensor([now, now + 5, now + 9], device=dev)
    seq = torch.zeros(1, dtype=torch.int64, device=dev)
    before_rest = {s: [c.clone() for c in be.tables[s]] for s in (0, 1, 3)}
    pt = clone_table(kt)
    torch.cuda.synchronize()
    launches = serve_kernel.launches
    with place.on_stream():
        _, kr, _ = serve_kernel.persistent_serve_step(
            kt, qs, nows, seq, 8, claim)
    _, pr, _ = ring_step(pt, qs, nows, seq, 8)
    torch.cuda.synchronize()
    assert serve_kernel.launches == launches + 1
    assert torch.equal(kr, pr)
    for x, y in zip(kt, pt):
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        assert torch.equal(x, y)
    for s, before in before_rest.items():
        for x, b in zip(be.tables[s], before):
            assert torch.equal(x, b)
    assert bool((claim == serve_kernel.INT32_MAX).all())
