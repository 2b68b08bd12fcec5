"""The serve kernel's plain version and wrapper
(gubernator_tpu_torch/ops/ring.py, ops/kernels/serve_kernel.py).

The plain k-round `ring_step` must match the JAX package's interpret-mode
persistent kernel and its `ring_step` BIT-EXACTLY across two successive
launches threading (table, seq) — the pattern of tests/test_serve_kernel.py.
On CPU tensors the wrapper takes the plain path and counts no launch; the
kernel itself is held against the plain version on a CUDA card only.  The
kernel's design rests on one premise, held here on the CPU: `ring_step`
applied owner by owner (owner = bucket % G, `ops/ring.owner_partition`)
equals one whole `ring_step` and the JAX package, bit for bit.

The JAX package is imported inside the tests that compare with it, so the
card's machine (no JAX there) can run the kernel test alone:
    python -m pytest --noconftest -m cuda tests/test_torch_serve_kernel.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gubernator_tpu_torch.ops.kernels import serve_kernel
from gubernator_tpu_torch.ops.ring import owner_partition, ring_step
from gubernator_tpu_torch.ops.state import (
    clone_table,
    init_table,
    table_from_host,
    table_to_host,
)
from gubernator_tpu_torch.testing import (
    KeySpace,
    owner_crowded_rounds,
    random_rounds,
    random_table,
)

NUM_SLOTS, B = 1024, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small, so torch's thread pool gains nothing; one
    pool per test worker would oversubscribe the CPU that the other
    workers' timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reqs(step: int, n: int = 10):
    from gubernator_tpu.core.types import Algorithm, RateLimitReq

    return [
        RateLimitReq(
            name="pk",
            unique_key=f"k{(step * 3 + i) % 7}",
            hits=1 + (i % 2),
            limit=40,
            duration=60_000,
            algorithm=(
                Algorithm.LEAKY_BUCKET if i % 3 == 0
                else Algorithm.TOKEN_BUCKET
            ),
        )
        for i in range(n)
    ]


def _packed_qs(clock, steps=4):
    from gubernator_tpu.ops.batch import pack_requests
    from gubernator_tpu.runtime.backend import pack_batch_q

    qs = []
    for s in range(steps):
        for db in pack_requests(_reqs(s), B, clock).rounds:
            qs.append(pack_batch_q(db))
    return np.stack(qs).astype(np.int64)


def _assert_same(jax_tbl, torch_tbl):
    host = table_to_host(torch_tbl)
    for f in jax_tbl._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jax_tbl, f)), host[f], err_msg=f)


def test_plain_ring_matches_jax_persistent_and_ring(frozen_clock):
    import jax.numpy as jnp

    from gubernator_tpu.ops.pallas.serve_kernel import (
        persistent_serve_step_impl,
    )
    from gubernator_tpu.ops.ring import ring_step as jax_ring_step
    from gubernator_tpu.ops.state import init_table as jax_init_table

    qs = _packed_qs(frozen_clock)
    k = qs.shape[0]
    now = np.int64(frozen_clock.millisecond_now())
    nows = np.full(k, now, dtype=np.int64)

    rt, rseq = jax_init_table(NUM_SLOTS), jnp.zeros((), jnp.int64)
    pt, pseq = jax_init_table(NUM_SLOTS), jnp.zeros((), jnp.int64)
    tt, tseq = init_table(NUM_SLOTS, "cpu"), torch.zeros((), dtype=torch.int64)
    for _ in range(2):  # the second launch sees the first's table
        rt, rresp, rseq = jax_ring_step(rt, qs, nows, rseq, ways=8)
        pt, presp, pseq = persistent_serve_step_impl(
            pt, qs, nows, pseq, ways=8, interpret=True)
        tt, tresp, tseq = ring_step(
            tt, torch.from_numpy(qs), torch.from_numpy(nows), tseq, 8)
        _assert_same(rt, tt)
        _assert_same(pt, tt)
        np.testing.assert_array_equal(np.asarray(rresp), tresp.numpy())
        np.testing.assert_array_equal(np.asarray(presp), tresp.numpy())
        assert int(rseq) == int(pseq) == int(tseq)
    assert int(tseq) == 2 * k


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_ring_matches_jax_on_random_rounds(seed):
    """Branch-covering rounds (testing.py) with per-round clocks."""
    import jax.numpy as jnp

    from gubernator_tpu.ops.ring import ring_step as jax_ring_step
    from gubernator_tpu.ops.state import SlotTable as JaxTable

    # The packed pattern's shapes (k=8 rounds of B lanes on NUM_SLOTS), so
    # the JAX ring_step compiled for the test above is reused.
    rng = np.random.default_rng(100 + seed)
    now = 1_700_000_000_000
    ks = KeySpace(rng, NUM_SLOTS, 8, hot_buckets=16)
    host = random_table(rng, ks, now)
    qs = random_rounds(rng, ks, host["key"], 8, B, now)
    nows = now + np.arange(8, dtype=np.int64) * 900
    jt = JaxTable(**{f: jnp.asarray(v) for f, v in host.items()})
    jt, jresp, jseq = jax_ring_step(jt, qs, nows, jnp.int64(3), ways=8)
    tt, tresp, tseq = ring_step(
        table_from_host(host, "cpu"), torch.from_numpy(qs),
        torch.from_numpy(nows), torch.tensor(3), 8)
    _assert_same(jt, tt)
    np.testing.assert_array_equal(np.asarray(jresp), tresp.numpy())
    assert int(jseq) == int(tseq) == 11


def _premise_case():
    """Full hot buckets and transient lanes: 8 rounds of B lanes, with
    per-round clocks, on NUM_SLOTS (the shapes of the tests above)."""
    rng = np.random.default_rng(7)
    now = 1_700_000_000_000
    ks = KeySpace(rng, NUM_SLOTS, 8, hot_buckets=2)
    host = random_table(rng, ks, now)
    qs = random_rounds(rng, ks, host["key"], 8, B, now)
    return host, qs, now + np.arange(8, dtype=np.int64) * 700


_JAX_PREMISE = {}


def _jax_persistent(host, qs, nows):
    """The JAX package's persistent kernel, in interpret mode, as its own
    tests run it on the CPU (computed once for the parametrised test)."""
    if not _JAX_PREMISE:
        import jax.numpy as jnp

        from gubernator_tpu.ops.pallas.serve_kernel import (
            persistent_serve_step_impl,
        )
        from gubernator_tpu.ops.state import SlotTable as JaxTable

        jt = JaxTable(**{f: jnp.asarray(v) for f, v in host.items()})
        jt, jresp, _ = persistent_serve_step_impl(
            jt, qs, nows, jnp.int64(0), ways=8, interpret=True)
        _JAX_PREMISE["out"] = (jt, np.asarray(jresp))
    return _JAX_PREMISE["out"]


@pytest.mark.parametrize("owners", [1, 3, 7, 33])
def test_owner_by_owner_equals_whole_ring_and_jax(owners):
    """Exact (bit for bit): the lists hold every active lane once, at
    owner = bucket % G; owners applied one by one in reverse order, each
    with the other owners' lanes inactive, give every active lane's
    response and the final table of one whole ring_step and of the JAX
    persistent kernel."""
    host, qs_np, nows_np = _premise_case()
    qs, nows = torch.from_numpy(qs_np), torch.from_numpy(nows_np)
    nb = NUM_SLOTS // 8
    owner, lists = owner_partition(qs, nb, owners)
    active = qs[:, 10] != 0
    bucket = qs[:, 0] & (nb - 1)
    assert torch.equal(owner[active], bucket[active] % owners)
    assert bool((owner[~active] == -1).all())
    for b in range(qs.shape[0]):
        ids = torch.cat(lists[b])
        assert len(ids) == int(active[b].sum())
        assert torch.equal(ids.sort().values, active[b].nonzero().flatten())
        for g, lanes in enumerate(lists[b]):
            assert bool((owner[b, lanes] == g).all())

    seq = torch.zeros((), dtype=torch.int64)
    whole, wresp, _ = ring_step(table_from_host(host, "cpu"), qs, nows, seq, 8)
    split = table_from_host(host, "cpu")
    sresp = torch.zeros_like(wresp)
    for g in reversed(range(owners)):
        part = qs.clone()
        part[:, 10] = torch.where(owner == g, qs[:, 10], 0)
        split, resp, _ = ring_step(split, part, nows, seq, 8)
        mine = (owner == g)[:, None, :].expand_as(resp)
        sresp[mine] = resp[mine]
    assert torch.equal(sresp, wresp)
    for x, y in zip(split, whole):
        if x.dtype == torch.float64:  # compare the float column as bits
            x, y = x.view(torch.int64), y.view(torch.int64)
        assert torch.equal(x, y)
    jt, jresp = _jax_persistent(host, qs_np, nows_np)
    _assert_same(jt, split)
    np.testing.assert_array_equal(jresp, sresp.numpy())
    # The case reaches what the premise is about: claims that contend and
    # lanes left transient.
    persist = wresp[:, 4] != 0
    assert int((active & ~persist).sum()) > 0
    assert int((active & persist & (wresp[:, 5] == 0)).sum()) > 0


def test_wrapper_takes_plain_path_on_cpu(frozen_clock):
    qs = torch.from_numpy(_packed_qs(frozen_clock))
    nows = torch.full((qs.shape[0],), frozen_clock.millisecond_now(),
                      dtype=torch.int64)
    seq = torch.zeros((), dtype=torch.int64)
    a, b = init_table(NUM_SLOTS, "cpu"), init_table(NUM_SLOTS, "cpu")
    before = serve_kernel.launches
    a, ra, sa = serve_kernel.persistent_serve_step(a, qs, nows, seq, 8)
    b, rb, sb = ring_step(b, qs, nows, seq, 8)
    assert serve_kernel.launches == before  # no kernel ran
    assert torch.equal(ra, rb) and int(sa) == int(sb) == qs.shape[0]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_wrapper_rejects_bad_inputs(frozen_clock):
    qs = torch.from_numpy(_packed_qs(frozen_clock))
    nows = torch.zeros(qs.shape[0], dtype=torch.int64)
    seq = torch.zeros((), dtype=torch.int64)
    t = init_table(NUM_SLOTS, "cpu")
    with pytest.raises(TypeError, match="qs"):
        serve_kernel.persistent_serve_step(t, qs.to(torch.int32), nows, seq)
    with pytest.raises(ValueError, match="nows"):
        serve_kernel.persistent_serve_step(t, qs, nows[:1], seq)
    with pytest.raises(ValueError, match="qs"):
        serve_kernel.persistent_serve_step(t, qs[:, :11], nows, seq)
    with pytest.raises(ValueError, match="contiguous"):
        serve_kernel.persistent_serve_step(
            t, qs.transpose(0, 2).contiguous().transpose(0, 2), nows, seq)
    bad = t._replace(remaining_f=t.remaining_f.to(torch.float32))
    with pytest.raises(TypeError, match="remaining_f"):
        serve_kernel.persistent_serve_step(bad, qs, nows, seq)
    with pytest.raises(ValueError, match="power of two"):
        serve_kernel.persistent_serve_step(
            init_table(24, "cpu"), qs, nows, seq)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """Bit-exact with restored claim words: a mixed case; one owner
    receiving every whole round; more owners than buckets (S = 256); and
    B = 2^18 lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    owners = serve_kernel.owners(dev)
    now = 1_700_000_000_000
    # (num_slots, k, B, hot buckets, crowd one owner)
    cases = [(1 << 14, 3, 2048, 32, False), (1 << 20, 3, 4096, 64, True),
             (256, 4, 64, 4, False), (1 << 20, 2, 1 << 18, 1024, False)]
    for n, (S, k, lanes, hot, crowd) in enumerate(cases):
        rng = np.random.default_rng(5 + n)
        ks = KeySpace(rng, S, 8, hot_buckets=hot)
        host = random_table(rng, ks, now)
        make = owner_crowded_rounds if crowd else random_rounds
        extra = (owners,) if crowd else ()
        qs = torch.from_numpy(
            make(rng, ks, host["key"], k, lanes, now, *extra)).to(dev)
        if crowd:
            own, _ = owner_partition(qs, S // 8, owners)
            assert bool((own[qs[:, 10] != 0] == 0).all())
        nows = torch.tensor([now + 900 * b for b in range(k)], device=dev)
        seq = torch.zeros((), dtype=torch.int64, device=dev)
        kt = table_from_host(host, dev)
        pt = clone_table(kt)
        claim = serve_kernel.new_claim_buffer(S, dev)
        before = serve_kernel.launches
        if n == 0:
            with pytest.raises(ValueError, match="claim"):
                serve_kernel.persistent_serve_step(kt, qs, nows, seq, 8)
        kt, kr, kseq = serve_kernel.persistent_serve_step(
            kt, qs, nows, seq, 8, claim)
        pt, pr, pseq = ring_step(pt, qs, nows, seq, 8)
        torch.cuda.synchronize()
        assert serve_kernel.launches == before + 1, n
        assert torch.equal(kr, pr) and int(kseq) == int(pseq) == k, n
        for x, y in zip(kt, pt):
            if x.dtype == torch.float64:  # compare the float column as bits
                x, y = x.view(torch.int64), y.view(torch.int64)
            assert torch.equal(x, y), n
        assert bool((claim == serve_kernel.INT32_MAX).all()), n


@pytest.mark.cuda
def test_engine_narrow_send_on_cuda_matches_the_cpu_engine():
    """K1 behind TorchBackend's narrow send: calls of 1 to 4096 occupied
    lanes (two rounds each, the second meeting keys of the first again),
    sent and launched at their occupied width, answer and leave the table
    as the plain version does on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    from gubernator_tpu_torch.core.clock import Clock
    from gubernator_tpu_torch.core.config import DeviceConfig
    from gubernator_tpu_torch.ops.batch import empty_batch
    from gubernator_tpu_torch.runtime.backend import TorchBackend

    clock = Clock()
    clock.freeze(1_700_000_000_000 * 10**6)
    engines = [TorchBackend(DeviceConfig(num_slots=1 << 14, ways=8,
                                         batch_size=4096, platform=p),
                            clock=clock) for p in ("cuda", "cpu")]
    rng = np.random.default_rng(18)
    pool = rng.integers(1, 2**62, size=6000)
    for step, n in enumerate([1, 129, 1000, 4096, 1000, 127]):
        clock.freeze((1_700_000_000_000 + 150 * step) * 10**6)
        keys = rng.choice(pool, size=n, replace=False)
        rounds = []
        for ks in (keys, keys[: max(1, n // 3)]):
            m = len(ks)
            db = empty_batch(4096)
            db.key_hash[:m] = ks
            db.hits[:m] = rng.integers(0, 3, m)
            db.limit[:m] = db.burst[:m] = rng.integers(1, 6, m)
            db.duration[:m] = rng.choice([50, 200, 60_000], m)
            db.algo[:m] = rng.integers(0, 2, m)
            db.active[:m] = True
            rounds.append(db)
        got, want = (be.step_rounds(rounds) for be in engines)
        for r, (g, w) in enumerate(zip(got, want)):
            for col in w:
                np.testing.assert_array_equal(
                    g[col], w[col], err_msg=f"{step} {r} {col}")
    got, want = (be.snapshot() for be in engines)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert bool((engines[0].claim == serve_kernel.INT32_MAX).all())
