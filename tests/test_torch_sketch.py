"""The sketch tier's plain version and K2's wrapper
(gubernator_tpu_torch/ops/sketch.py, ops/kernels/cms_kernel.py).

The plain step must match the JAX package BIT-EXACTLY: its scatter step
`cms_step_scatter_impl` (the form the JAX SketchBackend serves) on every
input, and its one-hot `cms_step_impl` and interpret-mode Pallas kernel
where a column's hits in one batch stay below 2^24 (those two sum hits in
float32; above that they part from the int32 scatter form, and the port
follows the scatter form).  Inputs come from the seeded makers of
gubernator_tpu_torch/testing.py; float outputs are compared as bits.

The JAX package is imported inside the tests, so this file collects without
it.  The kernel itself is held against the plain version on a CUDA card by
tests/test_torch_sketch_backend.py and chip_smoke.py.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gubernator_tpu_torch.ops import sketch as T
from gubernator_tpu_torch.ops.kernels import cms_kernel
from gubernator_tpu_torch.testing import (
    I32_MAX,
    WINDOW_CASES,
    cross_chunk_lanes,
    random_sketch,
    random_sketch_lanes,
    window_now,
)

NOW0 = 1_700_000_000_000
D, W = 4, 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small, so torch's thread pool gains nothing; one
    pool per test worker would oversubscribe the CPU that the other
    workers' timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_state(st):
    import jax.numpy as jnp

    from gubernator_tpu.ops.sketch import SketchState

    return SketchState(jnp.asarray(st["cur"]), jnp.asarray(st["prev"]),
                       jnp.int64(st["window_start"]),
                       jnp.int64(st["window_ms"]))


def torch_state(st):
    return T.SketchState(torch.from_numpy(st["cur"].copy()),
                         torch.from_numpy(st["prev"].copy()),
                         torch.tensor(st["window_start"], dtype=torch.int64),
                         torch.tensor(st["window_ms"], dtype=torch.int64))


def assert_same_state(js, ts, ctx=""):
    np.testing.assert_array_equal(np.asarray(js.cur), ts.cur.numpy(), ctx)
    np.testing.assert_array_equal(np.asarray(js.prev), ts.prev.numpy(), ctx)
    assert int(js.window_start) == int(ts.window_start), ctx
    assert int(js.window_ms) == int(ts.window_ms), ctx


def assert_same_step(jout, tout, ctx=""):
    assert_same_state(jout[0], tout[0], ctx)
    np.testing.assert_array_equal(np.asarray(jout[1]), tout[1].numpy(), ctx)
    np.testing.assert_array_equal(np.asarray(jout[2]), tout[2].numpy(), ctx)


def one_step_case(rng, case, B, huge_hits):
    big = rng.integers(-(2**63), 2**63 - 1, 4, dtype=np.int64)
    st = random_sketch(rng, D, W, NOW0, 1000, big)
    kh, hits, lim = random_sketch_lanes(rng, 1, B, big, huge_hits=huge_hits)
    return st, kh[0], hits[0], lim[0], window_now(case, NOW0, 1000)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_row_columns_matches_jax():
    """Wrapping multiply then LOGICAL shift: fingerprints with the top bit
    set and at the int64 bounds, all 8 rows, widths 1 to 2^20."""
    import jax.numpy as jnp

    from gubernator_tpu.ops.sketch import row_columns

    rng = np.random.default_rng(0)
    h = rng.integers(-(2**63), 2**63 - 1, 512, dtype=np.int64, endpoint=True)
    h[:6] = [-(2**63), 2**63 - 1, 0, -1, 1, -(2**62)]
    assert (h < 0).sum() > 200  # top bit set on many lanes
    for width in (1, 2, 1024, 1 << 20):
        want = np.asarray(row_columns(jnp.asarray(h), 8, width))
        got = T.row_columns(t(h), 8, width)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy(), f"W={width}")


def test_rotate_and_rotate_cond_match_jax():
    """The offsets of tests/test_sketch.py's differential (same window,
    sliding, one behind, far behind) and negative elapsed, from a window
    that holds counts in both tables; overlap compared as float32 bits."""
    from gubernator_tpu.ops.sketch import _rotate, _rotate_cond

    rng = np.random.default_rng(1)
    big = rng.integers(-(2**63), 2**63 - 1, 2, dtype=np.int64)
    st = random_sketch(rng, D, W, NOW0, 1000, big)
    for off in (0, 300, 700, 999, 1000, 1100, 1400, 1999, 2000, 4200, 4600,
                -1, -700, -1000, -5000):
        for jfn, tfn in ((_rotate, T._rotate), (_rotate_cond, T._rotate_cond)):
            js, jo = jfn(jax_state(st), np.int64(NOW0 + off))
            ts, to = tfn(torch_state(st), NOW0 + off)
            assert_same_state(js, ts, f"{tfn.__name__} off={off}")
            assert to.dtype == torch.float32
            assert np.asarray(jo).view(np.int32) == to.numpy().view(np.int32)


def test_plain_step_matches_jax_scatter_step():
    """Every window case, duplicate groups, inactive lanes, negative and
    zero hits, hits at the int32 bounds, cells near both int32 bounds (the
    estimate saturates, adds wrap)."""
    from gubernator_tpu.ops.sketch import cms_step_scatter_impl

    rng = np.random.default_rng(2)
    saturated = 0
    for case in WINDOW_CASES:
        st, kh, hits, lim, now = one_step_case(rng, case, 512, True)
        want = cms_step_scatter_impl(jax_state(st), kh, hits, lim,
                                     np.int64(now))
        got = T.cms_step_scatter_impl(torch_state(st), t(kh), t(hits),
                                      t(lim), now)
        assert_same_step(want, got, case)
        saturated += int((got[2] == I32_MAX).sum())
    assert saturated > 0


def test_plain_step_matches_jax_onehot_and_interpret_pallas():
    """The one-hot semantic reference and the Pallas kernel (interpret
    mode, block=256, as tests/test_sketch.py runs it), below 2^24 hits per
    column per block."""
    from gubernator_tpu.ops.pallas.cms_kernel import cms_step_pallas
    from gubernator_tpu.ops.sketch import cms_step_impl

    rng = np.random.default_rng(3)
    for case in WINDOW_CASES:
        st, kh, hits, lim, now = one_step_case(rng, case, 512, False)
        got = T.cms_step_scatter_impl(torch_state(st), t(kh), t(hits),
                                      t(lim), now)
        onehot = cms_step_impl(jax_state(st), kh, hits, lim, np.int64(now))
        assert_same_step(onehot, got, f"onehot {case}")
        pallas = cms_step_pallas(jax_state(st), kh, hits, lim, np.int64(now),
                                 block=256, interpret=True)
        assert_same_step(pallas, got, f"pallas {case}")


def test_multi_step_matches_jax_make_multi_step():
    """k chunks in order at one `now`, each seeing the previous chunk's
    adds; the state threads through a merge per window case."""
    from gubernator_tpu.ops.sketch import cms_step_scatter_impl
    from gubernator_tpu.runtime.sketch_backend import make_multi_step

    multi = make_multi_step(cms_step_scatter_impl)
    rng = np.random.default_rng(4)
    big = rng.integers(-(2**63), 2**63 - 1, 4, dtype=np.int64)
    st = random_sketch(rng, D, W, NOW0, 1000, big)
    js, ts = jax_state(st), torch_state(st)
    for case in WINDOW_CASES:
        kh, hits, lim = random_sketch_lanes(rng, 4, 128, big)
        now = window_now(case, int(ts.window_start), 1000)
        js, jp = multi(js, kh, hits, lim, np.int64(now))
        ts, tp = cms_kernel.cms_multi_step(ts, t(kh), t(hits), t(lim), now)
        assert_same_state(js, ts, case)
        assert tp.dtype == torch.int32 and tuple(tp.shape) == (4, 2, 128)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy(), case)


def test_one_key_across_32_chunks_matches_jax():
    """A W = 2^4 sketch, one key in all 32 chunks with limit 15: each chunk
    must see the adds of the chunks before it, so the key's estimate is c
    in chunk c and its first over lane is in chunk 15.  Exact against the
    JAX `make_multi_step` scatter form."""
    from gubernator_tpu.ops.sketch import cms_step_scatter_impl
    from gubernator_tpu.runtime.sketch_backend import make_multi_step

    rng = np.random.default_rng(6)
    kh, hits, lim, lane = cross_chunk_lanes(rng, 32, 64, 15)
    st = {"cur": np.zeros((D, 16), np.int32),
          "prev": np.zeros((D, 16), np.int32),
          "window_start": NOW0, "window_ms": 1000}
    js, jp = make_multi_step(cms_step_scatter_impl)(
        jax_state(st), kh, hits, lim, np.int64(NOW0))
    ts, tp = T.multi_step(torch_state(st), t(kh), t(hits), t(lim), NOW0)
    assert_same_state(js, ts)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    rows = np.arange(32)
    assert tp[rows, 1, lane].tolist() == list(range(32))
    over = tp[:, 0].numpy()
    assert over.sum() == over[rows, lane].sum() == 32 - 15
    assert int(np.flatnonzero(over.any(axis=1))[0]) == 15
    col = T.row_columns(t(kh[:1, lane[0]]), D, 16).numpy()[:, 0]
    assert ts.cur.numpy()[np.arange(D), col].tolist() == [32] * D


def test_corners_saturation_wrap_negative_inactive():
    """One key whose D cells sit at INT32_MAX - 1: its estimate saturates
    to INT32_MAX; +5 wraps the cells; a negative hit is added but never
    over; an inactive lane adds nothing and answers (0, not over); a key
    whose cells all hold -10 estimates negative."""
    from gubernator_tpu.ops.sketch import cms_step_scatter_impl

    big, neg = np.int64(-(2**63) + 12345), np.int64(2**62 + 7)
    st = {"cur": np.zeros((D, W), np.int32), "prev": np.zeros((D, W), np.int32),
          "window_start": NOW0, "window_ms": 1000}
    cols = T.row_columns(t(np.array([big, neg])), D, W).numpy()
    for d in range(D):
        st["cur"][d, cols[d, 0]] = I32_MAX - 1
        st["prev"][d, cols[d, 0]] = 2**30
        st["cur"][d, cols[d, 1]] = -10
    kh = np.array([big, big, neg, 0, neg], np.int64)
    hits = np.array([5, -7, 3, 100, 0], np.int32)
    lim = np.array([10, 10, 1, 0, -20], np.int32)
    now = NOW0 + 500
    want = cms_step_scatter_impl(jax_state(st), kh, hits, lim, np.int64(now))
    got = T.cms_step_scatter_impl(torch_state(st), t(kh), t(hits), t(lim),
                                  now)
    assert_same_step(want, got)
    assert got[2].tolist() == [I32_MAX, I32_MAX, -10, 0, -10]
    assert got[1].tolist() == [True, False, False, False, False]
    # INT32_MAX - 1 + 5 - 7 wraps around and back: INT32_MAX - 3.
    assert int(got[0].cur[0, cols[0, 0]]) == I32_MAX - 3
    assert int(got[0].cur[0, cols[0, 1]]) == -7


def test_hits_beyond_2p24_follow_the_scatter_form():
    """Duplicate lanes whose summed hits on a column pass 2^24: the port
    adds in int32 like `cms_step_scatter_impl`; the one-hot form (and the
    Pallas kernel, which sums the same way) round the sum in float32."""
    from gubernator_tpu.ops.sketch import cms_step_impl, cms_step_scatter_impl

    st = {"cur": np.zeros((D, W), np.int32), "prev": np.zeros((D, W), np.int32),
          "window_start": NOW0, "window_ms": 1000}
    kh = np.full(64, 987654321, np.int64)
    hits = np.full(64, 2**24 + 1, np.int32)
    hits[0] = 3
    lim = np.full(64, I32_MAX, np.int32)
    got = T.cms_step_scatter_impl(torch_state(st), t(kh), t(hits), t(lim),
                                  NOW0)
    want = cms_step_scatter_impl(jax_state(st), kh, hits, lim, np.int64(NOW0))
    assert_same_step(want, got)
    total = int(hits.astype(np.int64).sum()) % 2**32
    col = T.row_columns(t(kh[:1]), D, W).numpy()[:, 0]
    assert int(got[0].cur[0, col[0]]) == total - 2**32 * (total >= 2**31)
    onehot = cms_step_impl(jax_state(st), kh, hits, lim, np.int64(NOW0))
    assert not np.array_equal(np.asarray(onehot[0].cur), got[0].cur.numpy())


def test_wrapper_takes_plain_path_on_cpu():
    rng = np.random.default_rng(5)
    big = rng.integers(-(2**63), 2**63 - 1, 4, dtype=np.int64)
    st = random_sketch(rng, D, W, NOW0, 1000, big)
    kh, hits, lim = random_sketch_lanes(rng, 3, 64, big)
    now = window_now("one_behind", NOW0, 1000)
    before = cms_kernel.launches
    a, pa = cms_kernel.cms_multi_step(torch_state(st), t(kh), t(hits),
                                      t(lim), now)
    b, pb = T.multi_step(torch_state(st), t(kh), t(hits), t(lim), now)
    assert cms_kernel.launches == before  # no kernel ran
    assert torch.equal(pa, pb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # k = 0 chunks: nothing applies and the window does not roll.
    s0 = torch_state(st)
    e64, e32 = torch.zeros((0, 8), dtype=torch.int64), torch.zeros(
        (0, 8), dtype=torch.int32)
    s1, p0 = cms_kernel.cms_multi_step(s0, e64, e32, e32, now)
    assert tuple(p0.shape) == (0, 2, 8) and int(s1.window_start) == NOW0


def test_wrapper_rejects_bad_inputs():
    s = T.init_sketch(D, W, 1000, device="cpu")
    kh = torch.zeros((2, 8), dtype=torch.int64)
    h32 = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="kh"):
        cms_kernel.cms_multi_step(s, kh.to(torch.int32), h32, h32, 0)
    with pytest.raises(TypeError, match="hits"):
        cms_kernel.cms_multi_step(s, kh, kh, h32, 0)
    with pytest.raises(ValueError, match="lim"):
        cms_kernel.cms_multi_step(s, kh, h32, h32[:1], 0)
    with pytest.raises(ValueError, match="kh"):
        cms_kernel.cms_multi_step(s, kh[0], h32, h32, 0)
    with pytest.raises(ValueError, match="contiguous"):
        cms_kernel.cms_multi_step(
            s, torch.zeros((8, 2), dtype=torch.int64).t(), h32, h32, 0)
    bad = s._replace(prev=s.prev.to(torch.int64))
    with pytest.raises(TypeError, match="prev"):
        cms_kernel.cms_multi_step(bad, kh, h32, h32, 0)
    odd = s._replace(cur=torch.zeros((D, 12), dtype=torch.int32),
                     prev=torch.zeros((D, 12), dtype=torch.int32))
    with pytest.raises(ValueError, match="power of two"):
        cms_kernel.cms_multi_step(odd, kh, h32, h32, 0)
    with pytest.raises(ValueError, match="power of two"):
        T.init_sketch(4, 1000, device="cpu")
    with pytest.raises(ValueError, match="depth"):
        T.init_sketch(9, 1024, device="cpu")
    with pytest.raises(ValueError, match="window_ms"):
        T.init_sketch(4, 1024, 0, device="cpu")
