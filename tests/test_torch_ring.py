"""The port's ring drain discipline (gubernator_tpu_torch/runtime/ring.py and
ops/ring.py) on the CPU against the JAX package's.

The same packed rounds, on the same frozen clock, go through the port's
RingBackend over TorchBackend(cpu) and the JAX RingBackend over
DeviceBackend: responses and tables bit-exact.  Ring mode equals the
classic round-at-a-time dispatch, the megaround step equals the flat ring
(and JAX's megaround step), the sequence word is monotone with zero
mismatches, and the runner's failure contract (close mid-flight, a
partial submit, mixed batch tiers in one block) holds as it does for the
reference (tests/test_ring.py)."""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from gubernator_tpu.core.config import DeviceConfig as JaxDeviceConfig
from gubernator_tpu.ops.batch import pack_requests as jax_pack
from gubernator_tpu.runtime.backend import DeviceBackend
from gubernator_tpu.runtime.ring import RingBackend as JaxRingBackend
from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.core.types import Algorithm, RateLimitReq
from gubernator_tpu_torch.ops.batch import pack_batch_q, pack_requests
from gubernator_tpu_torch.runtime.backend import TorchBackend, tier_of
from gubernator_tpu_torch.runtime.ring import (
    PartialSubmitError,
    RingBackend,
    RingClosedError,
)

B = 64
COLS = ("status", "limit", "remaining", "reset_time", "persisted", "found",
        "stored", "cached", "stored_status")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_backend(clock, tiers=None) -> TorchBackend:
    return TorchBackend(DeviceConfig(num_slots=1024, ways=8, batch_size=B,
                                     platform="cpu", batch_tiers=tiers),
                        clock=clock)


def jax_backend(clock, tiers=None) -> DeviceBackend:
    return DeviceBackend(JaxDeviceConfig(num_slots=1024, ways=8,
                                         batch_size=B, batch_tiers=tiers),
                         clock=clock)


def reqs_for(rng: np.random.Generator, n: int, keys: int = 9):
    """Mixed token/leaky checks over a few keys (duplicates force several
    rounds), with resets and zero/negative hits."""
    out = []
    for _ in range(n):
        k = int(rng.integers(keys))
        out.append(RateLimitReq(
            name="ring", unique_key=f"k{k}",
            hits=int(rng.choice([0, 1, 1, 2, 3, -1])),
            limit=int(rng.choice([5, 20])), duration=60_000,
            algorithm=(Algorithm.LEAKY_BUCKET if k % 3 == 0
                       else Algorithm.TOKEN_BUCKET),
            behavior=4 if rng.random() < 0.05 else 0,  # RESET_REMAINING
            burst=int(rng.choice([0, 0, 25])),
        ))
    return out


def assert_same_host(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for c in COLS:
            n = w[c].shape[-1]
            np.testing.assert_array_equal(g[c][..., :n], w[c], err_msg=c)


def assert_same_tables(tb: TorchBackend, jb: DeviceBackend):
    t, j = tb.snapshot(), jb.snapshot()
    for f in j:
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)


@pytest.mark.parametrize("slots,rounds", [(2, 1), (2, 2)])
def test_ring_matches_classic_and_jax_ring(slots, rounds, frozen_clock):
    """The same merges through the port's ring, the JAX ring, and the
    port's classic step_rounds: every response column and the final tables
    bit-exact; the port's sequence word is monotone with no mismatch."""
    rng = np.random.default_rng(40 + rounds)
    tb, cb, jb = (port_backend(frozen_clock), port_backend(frozen_clock),
                  jax_backend(frozen_clock))
    ring = RingBackend(tb, slots=slots, rounds=rounds, max_linger_us=500.0)
    jring = JaxRingBackend(jb, slots=slots, rounds=rounds,
                           max_linger_us=500.0)
    seqs = [ring.seq]
    try:
        for step in range(8):
            reqs = reqs_for(rng, int(rng.integers(1, 40)))
            got = ring.submit_rounds(
                pack_requests(reqs, B, frozen_clock).rounds)()
            want = jring.submit_rounds(
                jax_pack(reqs, B, frozen_clock).rounds)()
            classic = cb.step_rounds(
                pack_requests(reqs, B, frozen_clock).rounds, add_tally=False)
            assert_same_host(got, want)
            assert_same_host(classic, want)
            seqs.append(ring.seq)
            frozen_clock.advance(int(rng.choice([0, 250, 61_000])))
    finally:
        ring.close()
        jring.close()
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    assert ring.seq_mismatches == 0 and ring.rounds_consumed > 8
    assert_same_tables(tb, jb)
    assert_same_tables(cb, jb)


def test_mega_ring_step_equals_flat_ring_and_jax(frozen_clock):
    """mega_ring_step over [r, s, 12, B] is the flat ring over r*s rounds,
    and equals the JAX megaround step on the same block."""
    import jax.numpy as jnp

    from gubernator_tpu.ops.ring import mega_ring_step as jax_mega
    from gubernator_tpu.ops.state import init_table as jax_init
    from gubernator_tpu_torch.ops.ring import mega_ring_step, ring_step
    from gubernator_tpu_torch.ops.state import init_table

    rng = np.random.default_rng(7)
    qs = np.stack([
        pack_batch_q(db) for s in range(4)
        for db in pack_requests(reqs_for(rng, 30), B, frozen_clock).rounds
    ])
    if qs.shape[0] % 2:
        qs = qs[:-1]
    k = qs.shape[0]
    nows = np.full(k, frozen_clock.millisecond_now(), dtype=np.int64)
    seq = torch.tensor(3, dtype=torch.int64)
    ft, fr, fs = ring_step(init_table(1024, "cpu"), torch.from_numpy(qs),
                           torch.from_numpy(nows), seq)
    mt, mr, ms = mega_ring_step(
        init_table(1024, "cpu"), torch.from_numpy(qs).reshape(k // 2, 2, 12, B),
        torch.from_numpy(nows).reshape(k // 2, 2), seq)
    jt, jr, js = jax_mega(jax_init(1024), qs.reshape(k // 2, 2, 12, B),
                          nows.reshape(k // 2, 2), jnp.int64(3), ways=8)
    assert tuple(mr.shape) == (k // 2, 2, 9, B)
    assert torch.equal(mr.reshape(k, 9, B), fr)
    np.testing.assert_array_equal(mr.numpy(), np.asarray(jr))
    for f, a, b, j in zip(ft._fields, ft, mt, jt):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
        np.testing.assert_array_equal(a.numpy(), np.asarray(j), err_msg=f)
    assert int(fs) == int(ms) == int(js) == 3 + k


def test_megaround_widens_under_backlog_and_stays_exact(frozen_clock):
    """A backlog past the base tier goes out as mega blocks (one dispatch
    of up to slots x rounds rounds) and still equals the JAX ring."""
    rng = np.random.default_rng(11)
    tb, jb = port_backend(frozen_clock), jax_backend(frozen_clock)
    ring = RingBackend(tb, slots=2, rounds=4, max_linger_us=20_000.0)
    jring = JaxRingBackend(jb, slots=2, rounds=4)
    gate = threading.Event()
    try:
        ring.submit_host(gate.wait)  # let a backlog form
        # One round each (no key repeats inside a batch), five in all:
        # past the base tier, inside the capacity, so nothing blocks.
        batches = []
        for j in range(5):
            reqs = reqs_for(rng, 20, keys=40)
            seen = set()
            batches.append([r for r in reqs if not (
                r.unique_key in seen or seen.add(r.unique_key))])
        waits = [ring.submit_rounds(pack_requests(r, B, frozen_clock).rounds)
                 for r in batches]
        gate.set()
        got = [w() for w in waits]
        want = [jring.submit_rounds(jax_pack(r, B, frozen_clock).rounds)()
                for r in batches]
    finally:
        gate.set()
        ring.close()
        jring.close()
    for g, w in zip(got, want):
        assert_same_host(g, w)
    assert ring.mega_iterations >= 1 and ring.max_block > ring.slots
    assert ring.seq_mismatches == 0
    assert_same_tables(tb, jb)


def test_mixed_tier_merges_coalesce(frozen_clock):
    """Merges packed at different batch tiers share one block; each comes
    back at its own tier and equals the classic dispatch."""
    from gubernator_tpu_torch.core.types import RateLimitReq as Req

    def uniq(tag, n):
        return [Req(name="mix", unique_key=f"{tag}{i}", hits=1, limit=9,
                    duration=60_000) for i in range(n)]

    tb, cb = (port_backend(frozen_clock, (8, B)),
              port_backend(frozen_clock, (8, B)))
    ring = RingBackend(tb, slots=4)
    gate = threading.Event()
    try:
        ring.submit_host(gate.wait)
        small = pack_requests(uniq("s", 2), B, frozen_clock).rounds
        big = pack_requests(uniq("b", 40), B, frozen_clock).rounds
        w_small, w_big = ring.submit_rounds(small), ring.submit_rounds(big)
        gate.set()
        got_small, got_big = w_small(), w_big()
    finally:
        gate.set()
        ring.close()
    assert ring.iterations == 1 and ring.max_block == 2
    assert got_small[0]["status"].shape[-1] == 8
    assert got_big[0]["status"].shape[-1] == B
    for tag, n, got in (("s", 2, got_small), ("b", 40, got_big)):
        want = cb.step_rounds(pack_requests(uniq(tag, n), B,
                                            frozen_clock).rounds,
                              add_tally=False)
        assert_same_host(got, want)


def test_partial_submit_raises_distinct_error(frozen_clock):
    """A merge wider than the ring that loses the ring between chunks
    raises PartialSubmitError, never the safe-to-redispatch
    RingClosedError."""
    tb = port_backend(frozen_clock)
    ring = RingBackend(tb, slots=2)
    gate = threading.Event()
    errs = []
    try:
        ring.submit_host(gate.wait)
        dup = [RateLimitReq(name="ring", unique_key="dup", hits=1, limit=40,
                            duration=60_000)] * 4
        rounds = pack_requests(dup, B, frozen_clock).rounds
        t = max(tier_of(db.active, tb._tiers) for db in rounds)
        qs = np.stack([tb.ring_pack_round(db, t) for db in rounds])
        assert qs.shape[0] > ring.slots

        def producer():
            try:
                ring.submit_q(qs)
            except BaseException as e:  # noqa: BLE001 — captured
                errs.append(e)

        th = threading.Thread(target=producer)
        th.start()
        time.sleep(0.3)
        ring._mark_broken()
        th.join(timeout=10)
        assert not th.is_alive()
    finally:
        gate.set()
        ring.close()
    assert len(errs) == 1 and isinstance(errs[0], PartialSubmitError)
    assert not isinstance(errs[0], RingClosedError)


def test_close_mid_flight(frozen_clock):
    """close() with work queued behind a stalled runner: the in-flight
    host job finishes, queued rounds fail with RingClosedError, new
    submissions fail fast, nothing hangs."""
    tb = port_backend(frozen_clock)
    ring = RingBackend(tb, slots=2)
    gate = threading.Event()
    inflight = ring.submit_host(lambda: (gate.wait(), "done")[1])
    time.sleep(0.1)  # the runner pops the host job and blocks inside it
    rounds = pack_requests(reqs_for(np.random.default_rng(1), 3), B,
                           frozen_clock).rounds
    queued = ring.submit_rounds(rounds)
    closer = threading.Thread(target=ring.close)
    closer.start()
    time.sleep(0.1)
    gate.set()
    closer.join(timeout=10)
    assert not closer.is_alive()
    assert inflight() == "done"
    with pytest.raises(RingClosedError):
        queued()
    with pytest.raises(RingClosedError):
        ring.submit_rounds(rounds)
    assert not ring.available() and ring.defunct


def test_persistent_mode_and_warmup_on_the_cpu(frozen_clock):
    """On the CPU the backend reports no persistent kernel (the fast lane
    degrades to megaround); a RingBackend driven through
    persistent_serve_dispatch still serves exactly, and warmup launches
    every (slot tier x batch tier) block without touching the table."""
    tb, jb = port_backend(frozen_clock), jax_backend(frozen_clock)
    ok, reason = tb.persistent_serve_supported()
    assert not ok and "cpu" in reason
    ring = RingBackend(tb, slots=2, rounds=2, persistent=True)
    jring = JaxRingBackend(jb, slots=2, rounds=2)
    try:
        ring.warmup()
        jring.warmup()
        assert tb.occupancy() == 0
        reqs = reqs_for(np.random.default_rng(5), 25)
        got = ring.submit_rounds(pack_requests(reqs, B, frozen_clock).rounds)()
        want = jring.submit_rounds(jax_pack(reqs, B, frozen_clock).rounds)()
    finally:
        ring.close()
        jring.close()
    assert_same_host(got, want)
    assert ring.seq == jring.seq and ring.seq_mismatches == 0
    assert ring.debug_vars()["persistent"] is True
    assert_same_tables(tb, jb)


@pytest.mark.cuda
def test_ring_on_the_card_matches_the_cpu_ring():
    """On the card every ring, megaround and persistent block is one K1
    dispatch fetched behind its own event: the same merges give the CPU
    ring's responses and table, the sequence word never disagrees, and K1
    launched for every block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    from gubernator_tpu_torch.core.clock import Clock
    from gubernator_tpu_torch.ops.kernels import serve_kernel

    clock = Clock()
    clock.freeze(1_760_000_000_000 * 1_000_000)
    for rounds, persistent in ((1, False), (2, False), (2, True)):
        cuda_be = TorchBackend(DeviceConfig(num_slots=1024, ways=8,
                                            batch_size=B), clock=clock)
        cpu_be = port_backend(clock)
        ring = RingBackend(cuda_be, slots=2, rounds=rounds,
                           persistent=persistent, max_linger_us=500.0)
        cring = RingBackend(cpu_be, slots=2, rounds=rounds)
        rng = np.random.default_rng(rounds)
        try:
            ring.warmup()
            cring.warmup()
            serve_kernel.launches = 0
            for _ in range(6):
                reqs = reqs_for(rng, int(rng.integers(1, 40)))
                rounds_ = pack_requests(reqs, B, clock).rounds
                assert_same_host(ring.submit_rounds(rounds_)(),
                                 cring.submit_rounds(rounds_)())
        finally:
            ring.close()
            cring.close()
        assert serve_kernel.launches == ring.iterations > 0
        assert ring.seq_mismatches == 0 and ring.seq == cring.seq
        assert_same_tables(cuda_be, cpu_be)
