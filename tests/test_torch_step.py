"""The torch port's plain decision step (gubernator_tpu_torch/ops/step.py)
against gubernator_tpu.ops.step.apply_batch_packed_q: BIT-EXACT on all 12
table columns and the 9 response rows, on seeded random tables and rounds
that reach every branch (gubernator_tpu_torch/testing.py), plus the int64
corners of `_trunc_i64` and the saturating add/sub against the JAX helpers
and the sequential oracle."""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.core.pymodel import _sat_add, _sat_sub, _trunc
from gubernator_tpu.ops import step as jstep
from gubernator_tpu.ops.state import SlotTable as JaxTable
from gubernator_tpu_torch.ops import step as tstep
from gubernator_tpu_torch.ops.state import table_from_host, table_to_host
from gubernator_tpu_torch.testing import KeySpace, random_rounds, random_table

NOW = 1_700_000_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small, so torch's thread pool gains nothing; one
    pool per test worker would oversubscribe the CPU that the other
    workers' timing-sensitive tests share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_table(host) -> JaxTable:
    return JaxTable(**{f: jnp.asarray(host[f]) for f in JaxTable._fields})


def assert_tables_equal(jax_tbl, host) -> None:
    for f in JaxTable._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jax_tbl, f)), host[f], err_msg=f
        )


def run_both(seed: int, num_slots: int, B: int, k: int, hot: int):
    """k rounds through both steps; returns the stacked JAX responses."""
    rng = np.random.default_rng(seed)
    ks = KeySpace(rng, num_slots, 8, hot_buckets=hot)
    host = random_table(rng, ks, NOW)
    qs = random_rounds(rng, ks, host["key"], k, B, NOW)
    jt = jax_table(host)
    tt = table_from_host(host, "cpu")
    out = []
    for b in range(k):
        now = NOW + 3 * b
        jt, jr = jstep.apply_batch_packed_q(
            jt, jnp.asarray(qs[b]), jnp.int64(now), ways=8
        )
        tt, tr = tstep.apply_batch_packed_q(tt, torch.from_numpy(qs[b]), now, 8)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        assert_tables_equal(jt, table_to_host(tt))
        out.append((qs[b], np.asarray(jr)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_plain_step_bit_exact_vs_jax(seed):
    run_both(seed, 256, 64, 3, hot=4)


def test_plain_step_reaches_every_lane_outcome():
    """Across a few seeds the inputs produce every lane outcome: found,
    inserted, transient (all 3 claim rounds lost), cached, over limit."""
    seen = np.zeros(5, dtype=np.int64)
    for seed in range(10, 16):
        for q, r in run_both(seed, 256, 64, 3, hot=4):
            act = q[10] != 0
            seen += [
                (r[5] == 1).sum(),
                (act & (r[4] == 1) & (r[5] == 0)).sum(),
                (act & (r[4] == 0)).sum(),
                (r[7] == 1).sum(),
                (r[0] == 1).sum(),
            ]
    assert (seen > 0).all(), seen


# -- corners -------------------------------------------------------------

_I64_MAX, _I64_MIN = 2**63 - 1, -(2**63)

_CORNERS = [
    0, 1, -1, 2, -2,
    2**31 - 1, 2**31, 2**31 + 1, -(2**31) - 1, -(2**31), -(2**31) + 1,
    2**53 - 1, 2**53, 2**53 + 1, -(2**53) - 1, -(2**53), -(2**53) + 1,
    2**62, -(2**62),
    _I64_MAX - 1, _I64_MAX, _I64_MIN, _I64_MIN + 1,
]

_F64_BELOW_2_63 = math.nextafter(2.0**63, 0.0)
_TRUNC_EDGES = [
    0.0, -0.0, 0.5, -0.5, 1.9, -1.5, -2.7, 2.999, 2.5, -2.5,
    2.0**62, -(2.0**62), 2.0**62 + 4096.0, -(2.0**62) - 4096.0,
    float(2**53) - 1.0, float(2**53), float(2**53) + 2.0,
    _F64_BELOW_2_63, -_F64_BELOW_2_63,
    2.0**63, -(2.0**63), 9.3e18, -9.3e18, 1e308, -1e308,
    math.nextafter(-(2.0**63), -math.inf),
    math.inf, -math.inf, math.nan,
    math.nextafter(1.0, 0.0), math.nextafter(-1.0, 0.0),
]


def test_trunc_corners():
    got = tstep._trunc_i64(
        torch.tensor(_TRUNC_EDGES, dtype=torch.float64)).tolist()
    ref = np.asarray(
        jstep._trunc_i64(jnp.asarray(_TRUNC_EDGES, jnp.float64))).tolist()
    assert got == ref
    assert got == [_trunc(x) for x in _TRUNC_EDGES]


@pytest.mark.parametrize("op", ["add", "sub"])
def test_saturating_corners(op):
    a = [x for x in _CORNERS for _ in _CORNERS]
    b = [y for _ in _CORNERS for y in _CORNERS]
    t_fn = tstep._sat_add_i64 if op == "add" else tstep._sat_sub_i64
    j_fn = jstep._sat_add_i64 if op == "add" else jstep._sat_sub_i64
    o_fn = _sat_add if op == "add" else _sat_sub
    got = t_fn(torch.tensor(a, dtype=torch.int64),
               torch.tensor(b, dtype=torch.int64)).tolist()
    ref = np.asarray(j_fn(jnp.asarray(a, jnp.int64),
                          jnp.asarray(b, jnp.int64))).tolist()
    assert got == ref
    assert got == [o_fn(x, y) for x, y in zip(a, b)]
