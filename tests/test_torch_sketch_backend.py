"""The port's SketchBackend (gubernator_tpu_torch/runtime/sketch_backend.py)
on the CPU against gubernator_tpu's SketchBackend: the same requests under
the same frozen clock give the same responses, response by response, through
check(), check_cols() and pipelined check_cols_begin(), validation errors,
the int32 clamps, spillover and the exact-pressure policy; HostCMS against
its JAX copy; the refusal to run on a CUDA device that is not there; and,
on a card, K2 against its plain version.

The JAX package is imported inside the tests that compare with it, so the
card's machine can run the kernel test alone:
    python -m pytest --noconftest -m cuda tests/test_torch_sketch_backend.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gubernator_tpu_torch.core.clock import Clock
from gubernator_tpu_torch.core.config import SketchTierConfig
from gubernator_tpu_torch.core.types import RateLimitReq
from gubernator_tpu_torch.runtime.sketch_backend import HostCMS, SketchBackend

T0_NS = 1_700_000_000_123 * 1_000_000
TIER = dict(names=["cms", "ip"], depth=4, width=1024, window_ms=1000,
            batch_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small, so torch's thread pool gains nothing; one
    pool per test worker would oversubscribe the CPU that the other
    workers' timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clock():
    c = Clock()
    c.freeze(T0_NS)
    return c


def pair(clock, **kw):
    """(port on the CPU, JAX package) backends on one shared frozen clock."""
    from gubernator_tpu.core.config import SketchTierConfig as JaxTier
    from gubernator_tpu.runtime.sketch_backend import (
        SketchBackend as JaxSketchBackend,
    )

    cfg = {**TIER, **kw}
    return (SketchBackend(SketchTierConfig(**cfg), clock=clock, device="cpu"),
            JaxSketchBackend(JaxTier(**cfg), clock=clock))


def resp_key(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error,
            dict(r.metadata))


def assert_same(got, want, ctx=""):
    assert [resp_key(r) for r in got] == [resp_key(r) for r in want], ctx


def assert_same_sketch(tb, jb):
    np.testing.assert_array_equal(tb.state.cur.numpy(),
                                  np.asarray(jb.state.cur))
    np.testing.assert_array_equal(tb.state.prev.numpy(),
                                  np.asarray(jb.state.prev))
    assert int(tb.state.window_start) == int(jb.state.window_start)
    assert tb._win_start == jb._win_start == int(tb.state.window_start)


def random_reqs(rng, n):
    """Hot and cold keys (duplicates within a call), zero / negative hits,
    limits and hits beyond int32 (clamped), and a few invalid requests."""
    reqs = []
    for _ in range(n):
        roll = rng.random()
        reqs.append(RateLimitReq(
            name="" if roll < 0.01 else str(rng.choice(["cms", "ip"])),
            unique_key="" if 0.01 <= roll < 0.02 else
            f"k{int(rng.integers(0, 8 if roll < 0.3 else 5000))}",
            hits=int(rng.choice([0, 1, 1, 1, 2, 5, -1, 2**40, -(2**35)])
                     if roll < 0.97 else rng.integers(-2**63, 2**63 - 1)),
            limit=int(rng.choice([1, 5, 20, 100, 2**33, -(2**33), 0])),
            duration=1000,
        ))
    return reqs


@pytest.mark.parametrize("seed", [1, 2])
def test_check_matches_jax_backend(seed, clock):
    """Calls of 1 to 300 requests (1 to 8 chunks of 64) while the clock
    moves through every window case, including backwards."""
    rng = np.random.default_rng(seed)
    tb, jb = pair(clock)
    over = 0
    for step in range(25):
        reqs = random_reqs(rng, int(rng.integers(1, 300)))
        got = tb.check(reqs)
        assert_same(got, jb.check(reqs), f"step={step}")
        over += sum(r.status for r in got)
        clock.advance(int(rng.choice([0, 0, 150, 400, 1100, 3500, -700])))
    assert over > 0
    assert_same_sketch(tb, jb)
    assert tb.check([]) == jb.check([]) == []


def test_check_cols_and_pipelined_begin_match_jax(clock):
    """Columnar entry points; two merges dispatched before either is
    fetched, across a roll of the window."""
    rng = np.random.default_rng(7)
    tb, jb = pair(clock)
    for step in range(6):
        n = int(rng.integers(1, 200))
        kh = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
        kh[rng.random(n) < 0.1] = 0
        kh[: n // 4] = kh[n // 2]
        hits = rng.integers(-2, 6, n).astype(np.int64)
        lim = rng.integers(0, 40, n).astype(np.int64)
        want = jb.check_cols(kh, hits, lim)
        got = tb.check_cols(kh, hits, lim)
        for w, g in zip(want, got):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(w, g, f"step={step}")
        fj1 = jb.check_cols_begin(kh, hits, lim)
        ft1 = tb.check_cols_begin(kh, hits, lim)
        clock.advance(700)
        fj2 = jb.check_cols_begin(kh[::-1].copy(), hits, lim)
        ft2 = tb.check_cols_begin(kh[::-1].copy(), hits, lim)
        for fj, ft in ((fj2, ft2), (fj1, ft1)):  # fetched out of order
            for w, g in zip(fj(), ft()):
                np.testing.assert_array_equal(w, g, f"step={step}")
    assert_same_sketch(tb, jb)


def test_validation_errors_match(clock):
    tb, jb = pair(clock)
    reqs = [
        RateLimitReq(name="cms", unique_key="", hits=1, limit=5),
        RateLimitReq(name="", unique_key="a", hits=1, limit=5),
        RateLimitReq(name="cms", unique_key="a", hits=3, limit=5),
        RateLimitReq(name="cms", unique_key="a", hits=3, limit=5),
    ]
    got = tb.check(reqs)
    assert_same(got, jb.check(reqs))
    assert [r.error != "" for r in got] == [True, True, False, False]
    assert "unique_key" in got[0].error and "namespace" in got[1].error
    # Both valid lanes saw the pre-batch estimate 0; the next call sees 6.
    assert [r.remaining for r in got[2:]] == [2, 2]
    again = tb.check(reqs[2:3])
    assert_same(again, jb.check(reqs[2:3]))
    assert int(again[0].status) == 1
    only_bad = reqs[:2]
    assert_same(tb.check(only_bad), jb.check(only_bad))


def test_spill_name_and_dynamic_hashes_match(clock):
    tb, jb = pair(clock)
    fired = []
    tb.on_spill = lambda: fired.append(1)
    assert tb.spill_enabled is jb.spill_enabled is False
    for name in ("cms", "api", "login", "api"):
        assert tb.spill_name(name) == jb.spill_name(name)
    np.testing.assert_array_equal(tb.dynamic_hashes(), jb.dynamic_hashes())
    assert tb.spillovers == jb.spillovers == 2 and len(fired) == 2
    assert tb.membership_version == jb.membership_version == 2
    for name in ("cms", "api", "other"):
        r = RateLimitReq(name=name, unique_key="u", hits=1, limit=3)
        assert tb.handles(r) == jb.handles(r) == (name != "other")
    reqs = [RateLimitReq(name="api", unique_key=f"u{i % 3}", hits=1, limit=2)
            for i in range(12)]
    assert_same(tb.check(reqs), jb.check(reqs))


def test_note_exact_pressure_batch_matches(clock):
    """The HyperLogLog cardinality policy and the transient counter cross
    their thresholds on the same drain in both packages."""
    tb, jb = pair(clock, spill_inserts=300, spill_transients=50)
    assert tb.spill_enabled and jb.spill_enabled
    rng = np.random.default_rng(9)
    names = {101: "bomb", 202: "churn", 303: "evicted"}
    for drain in range(12):
        items = [
            (101, rng.integers(-(2**63), 2**63 - 1, 40, dtype=np.int64), 0),
            # a small key set re-inserted forever: never a bomb
            (202, rng.integers(1, 20, 40).astype(np.int64), 0),
            (303, np.empty(0, dtype=np.int64), 6),
        ]
        assert tb.note_exact_pressure_batch(items, names.__getitem__) == \
            jb.note_exact_pressure_batch(items, names.__getitem__), drain
        assert tb._dyn_names == jb._dyn_names, drain
    assert tb._dyn_names == {"bomb", "evicted"}
    np.testing.assert_array_equal(tb.dynamic_hashes(), jb.dynamic_hashes())
    assert set(tb._pressure) == set(jb._pressure)
    for h, (regs, transients) in tb._pressure.items():
        np.testing.assert_array_equal(regs, jb._pressure[h][0])
        assert transients == jb._pressure[h][1]


def test_host_cms_matches_jax_copy():
    from gubernator_tpu.runtime.sketch_backend import HostCMS as JaxHostCMS

    rng = np.random.default_rng(11)
    for depth, width in ((1, 1), (4, 4096), (6, 64)):
        a, b = HostCMS(depth, width), JaxHostCMS(depth, width)
        for _ in range(3):
            kh = rng.integers(-(2**63), 2**63 - 1, 500, dtype=np.int64)
            kh[:100] = kh[100]
            w = rng.integers(-3, 9, 500)
            a.update(kh, w)
            b.update(kh, w)
            np.testing.assert_array_equal(a.table, b.table)
            np.testing.assert_array_equal(a.estimate(kh), b.estimate(kh))
        assert a.estimate_one(int(kh[0])) == b.estimate_one(int(kh[0]))
        a.clear()
        assert not a.table.any()
    for bad in ((4, 1000), (0, 64), (7, 64)):
        with pytest.raises(ValueError):
            HostCMS(*bad)


def test_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SketchBackend(SketchTierConfig(names=["cms"]))
    cpu = SketchBackend(SketchTierConfig(names=["cms"]), device="cpu")
    cpu.warmup()  # nothing to build on the CPU
    assert cpu.state.cur.device.type == "cpu"


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    from gubernator_tpu_torch.ops.kernels import cms_kernel
    from gubernator_tpu_torch.ops.sketch import SketchState, multi_step
    from gubernator_tpu_torch.testing import (
        WINDOW_CASES,
        cross_chunk_lanes,
        random_sketch,
        random_sketch_lanes,
        window_now,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    big = rng.integers(-(2**63), 2**63 - 1, 8, dtype=np.int64)
    ws = T0_NS // 10**6
    # Every window case at 1024 lanes a chunk (one block walks them) and at
    # 1025 (the grid walks them); then one key across 32 chunks of a 2^4
    # sketch, whose cells every chunk must re-read after the last adds.
    cases = [(case, 1 << 12, random_sketch_lanes(rng, 3, lanes, big))
             for case in WINDOW_CASES for lanes in (1024, 1025)]
    cross = cross_chunk_lanes(rng, 32, 1024, 15)
    cases.append(("in_window", 16, cross[:3]))
    for case, width, lanes in cases:
        st = random_sketch(rng, 4, width, ws, 60_000, big)
        if width == 16:
            st["cur"][:] = 0
            st["prev"][:] = 0
        kh, hits, lim = (torch.from_numpy(a).to(dev) for a in lanes)
        now = window_now(case, st["window_start"], 60_000)

        def state():
            return SketchState(
                torch.from_numpy(st["cur"]).to(dev),
                torch.from_numpy(st["prev"]).to(dev),
                torch.tensor(st["window_start"], device=dev),
                torch.tensor(st["window_ms"], device=dev))

        before = cms_kernel.launches
        ks, kp = cms_kernel.cms_multi_step(state(), kh, hits, lim, now)
        ps, pp = multi_step(state(), kh, hits, lim, now)
        torch.cuda.synchronize()
        assert cms_kernel.launches == before + 1, case
        assert torch.equal(kp, pp), (case, width, kh.shape)
        for x, y in zip(ks, ps):
            assert torch.equal(x, y), (case, width, kh.shape)
    rows = torch.arange(32)
    assert kp[rows, 1, torch.from_numpy(cross[3])].tolist() == list(range(32))
    be = SketchBackend(SketchTierConfig(names=["cms"], width=1 << 12,
                                        batch_size=256))
    be.warmup()
    before = cms_kernel.launches
    # 50 keys, ~5 hits each per chunk of 256: the 4 chunks of the first
    # call stay under 25, the second call's later chunks go over.
    reqs = [RateLimitReq(name="cms", unique_key=f"u{i % 50}", hits=1,
                         limit=25) for i in range(1000)]
    first, second = be.check(reqs), be.check(reqs)
    assert cms_kernel.launches == before + 2
    assert all(r.status == 0 for r in first)
    assert any(r.status == 1 for r in second)
