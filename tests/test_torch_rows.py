"""The port's state-plane ops (gubernator_tpu_torch/ops/step.py load_rows,
probe_batch, gather_rows; ops/state.py migrate_extract, migrate_inject,
demote_extract, table_stats) against the JAX package's forms: BIT-EXACT on
every output and on all 12 table columns after each op, on seeded tables
(gubernator_tpu_torch/testing) with tied touch stamps, full buckets that
four inserts contend for, protected fingerprints, expired rows,
KIND_CACHED_RESP rows and leaky rows with fractional remaining."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import state as jstate
from gubernator_tpu.ops import step as jstep
from gubernator_tpu.ops.state import SlotTable as JaxTable
from gubernator_tpu_torch.ops import state as tstate
from gubernator_tpu_torch.ops import step as tstep
from gubernator_tpu_torch.ops.state import table_from_host, table_to_host
from gubernator_tpu_torch.testing import (
    KeySpace,
    random_bucket_rows,
    random_table,
)

NOW = 1_700_000_000_000
SLOTS = 512
B = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(seed: int):
    """(rng, keyspace, host table, JAX table, torch table)."""
    rng = np.random.default_rng(seed)
    ks = KeySpace(rng, SLOTS, 8, hot_buckets=4)
    host = random_table(rng, ks, NOW)
    jt = JaxTable(**{f: jnp.asarray(host[f]) for f in JaxTable._fields})
    return rng, ks, host, jt, table_from_host(host, "cpu")


def assert_tables_equal(jt, tt) -> None:
    host = table_to_host(tt)
    for f in JaxTable._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jt, f)), host[f], err_msg=f)


def probe_keys(rng, ks, host) -> np.ndarray:
    """Live, expired, cached and absent fingerprints, plus inactive 0s."""
    present = host["key"][host["key"] != 0]
    h = np.concatenate([
        rng.choice(present, B // 2, replace=False),
        ks.in_bucket(rng.integers(0, ks.nb, B // 2 - 4)),
        np.zeros(4, dtype=np.int64),
    ])
    return rng.permutation(h)


def rows_pair(cols):
    return (jstep.BucketRows(**{f: jnp.asarray(v) for f, v in cols.items()}),
            tstep.BucketRows(**{f: torch.from_numpy(v)
                                for f, v in cols.items()}))


@pytest.mark.parametrize("seed", range(2))
def test_probe_and_gather_rows_bit_exact(seed):
    rng, ks, host, jt, tt = make(seed)
    h = probe_keys(rng, ks, host)
    jf, js = jstep.probe_batch(jt, jnp.asarray(h), jnp.int64(NOW), ways=8)
    tf, ts = tstep.probe_batch(tt, torch.from_numpy(h), NOW, 8)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert tf.any() and not tf.all()
    jp, jr = jstep.gather_rows(jt, jnp.asarray(h), jnp.int64(NOW), ways=8)
    tp, tr = tstep.gather_rows(tt, torch.from_numpy(h), NOW, 8)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    assert_tables_equal(jt, tt)


@pytest.mark.parametrize("seed", range(2))
def test_load_rows_bit_exact_with_fourth_contender_dropped(seed):
    rng, ks, host, jt, tt = make(seed)
    cols = random_bucket_rows(rng, ks, host["key"], B, NOW)
    # Only fresh keys: load_rows upserts, it does not merge.
    cols["key_hash"][np.isin(cols["key_hash"], host["key"])] = 0
    jr, tr = rows_pair(cols)
    jt = jstep.load_rows(jt, jr, jnp.int64(NOW), ways=8)
    tstep.load_rows(tt, tr, NOW, 8)
    assert_tables_equal(jt, tt)
    landed = np.isin(cols["key_hash"], table_to_host(tt)["key"])
    hot = np.isin(cols["key_hash"] & (ks.nb - 1), ks.hot)
    act = cols["key_hash"] != 0
    assert landed[act & ~hot].all()
    # Five fresh keys per full hot bucket: three claim rounds, so some
    # contender finds no slot and is dropped, in both packages.
    assert not landed[act & hot].all()


@pytest.mark.parametrize("seed", range(2))
def test_migrate_extract_bit_exact(seed):
    rng, ks, host, jt, tt = make(seed)
    h = probe_keys(rng, ks, host)
    jt, jp, jr = jstate.migrate_extract(
        jt, jnp.asarray(h), jnp.int64(NOW), ways=8)
    tt, tp, tr = tstate.migrate_extract(tt, torch.from_numpy(h), NOW, 8)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    assert_tables_equal(jt, tt)
    # Every extracted row was gathered before its slot was cleared.
    found = tp[0].numpy() != 0
    assert found.any()
    assert not np.isin(h[found], table_to_host(tt)["key"]).any()


@pytest.mark.parametrize("seed", range(2))
def test_migrate_inject_bit_exact_with_merges(seed):
    rng, ks, host, jt, tt = make(seed)
    cols = random_bucket_rows(rng, ks, host["key"], B, NOW)
    jr, tr = rows_pair(cols)
    jt, jres = jstate.migrate_inject(jt, jr, jnp.int64(NOW), ways=8)
    tt, tres = tstate.migrate_inject(tt, tr, NOW, 8)
    np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
    assert_tables_equal(jt, tt)
    merged = tres.numpy() & (cols["key_hash"] != 0)
    assert merged.any() and (cols["algo"][merged] == 1).any()


@pytest.mark.parametrize("seed", range(2))
def test_demote_extract_bit_exact(seed):
    rng, ks, host, jt, tt = make(seed)
    live = (host["key"] != 0) & (host["expire_at"] > NOW)
    protect = np.zeros(16, dtype=np.int64)
    protect[:10] = rng.choice(host["key"][live], 10, replace=False)
    n_elig = int((live & (host["kind"] == 0)
                  & ~np.isin(host["key"], protect)).sum())
    for batch in (32, n_elig + 7):  # tied stamps, then past the population
        jt, jp, jr = jstate.demote_extract(
            jt, jnp.asarray(protect), jnp.int64(NOW), ways=8, batch=batch)
        tt, tp, tr = tstate.demote_extract(
            tt, torch.from_numpy(protect), NOW, 8, batch)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        assert_tables_equal(jt, tt)
        assert not np.isin(tp[0].numpy(), protect[:10]).any()
    left = table_to_host(tt)
    assert not ((left["key"] != 0) & (left["expire_at"] > NOW)
                & (left["kind"] == 0)
                & ~np.isin(left["key"], protect)).any()


@pytest.mark.parametrize("seed", range(2))
def test_table_stats_bit_exact(seed):
    rng, ks, host, jt, tt = make(seed)
    present = host["key"][host["key"] != 0]
    fps = np.zeros((len(tstate.SHADOW_PLANES), 8), dtype=np.int64)
    fps[:, :6] = rng.choice(present, (fps.shape[0], 6))
    fps[1, 6] = ks.in_bucket(np.array([3]))[0]
    js = jstate.table_stats(jt, jnp.asarray(fps), jnp.int64(NOW), ways=8)
    ts = tstate.table_stats(tt, torch.from_numpy(fps), NOW, 8)
    for f in jstate.TableStats._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(ts.live) > 0 and int(ts.expired_resident) > 0
    assert_tables_equal(jt, tt)
