"""The single-table engine sends only a call's occupied lanes and launches
the serve kernel on them alone (gubernator_tpu_torch/runtime/backend.py
`occupied_q`, `TorchBackend._pack_rounds`), on the CPU.

At a batch of 4096 with the default tiers (128, 4096), calls of 1 to 4096
occupied lanes (token and leaky buckets mixed, keys met again across calls
and within a call, short durations expiring under a frozen clock) answer and
leave the table exactly as the same rounds sent whole at the tier through
`persistent_serve_step`, and as gubernator_tpu's `DeviceBackend`; the host
dicts, and the block the kernel runs on, are as wide as the occupied lanes,
rounded up to 128 and at most the tier.  The callers that keep sending the
whole tier (a shard grid's `MeshBackend` dispatch and the GLOBAL engine's
ingest) still do.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gubernator_tpu.core.config import DeviceConfig as JaxDeviceConfig
from gubernator_tpu.ops.batch import DeviceBatch as JaxDeviceBatch
from gubernator_tpu.runtime.backend import DeviceBackend
from gubernator_tpu_torch.core.config import DeviceConfig
from gubernator_tpu_torch.core.types import Behavior, RateLimitReq
from gubernator_tpu_torch.ops.batch import empty_batch
from gubernator_tpu_torch.ops.kernels.serve_kernel import persistent_serve_step
from gubernator_tpu_torch.parallel.global_sync import GlobalEngine
from gubernator_tpu_torch.parallel.sharded import (
    MeshBackend,
    pack_requests_sharded,
)
from gubernator_tpu_torch.runtime import backend as backend_mod
from gubernator_tpu_torch.runtime.backend import (
    TorchBackend,
    occupied_q,
    resolve_tiers,
    rounds_to_qs,
)

BATCH, SLOTS, WAYS = 4096, 1 << 14, 8
# Clock steps between calls (ms): durations of 50 and 200 ms expire.
STEPS = (0, 120, 400)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def call_rounds(rng, pool, n):
    """One call: a round of `n` lanes of distinct keys from `pool`, then a
    round of a third of them again (a key met twice in one call goes to a
    second round).  Token and leaky buckets, limits 1-5, durations 50 ms,
    200 ms or a minute."""
    keys = rng.choice(pool, size=n, replace=False)
    again = keys[: max(1, n // 3)]
    rounds = []
    for ks in (keys, again):
        m = len(ks)
        db = empty_batch(BATCH)
        db.key_hash[:m] = ks
        db.hits[:m] = rng.integers(0, 3, m)
        db.limit[:m] = db.burst[:m] = rng.integers(1, 6, m)
        db.duration[:m] = rng.choice([50, 200, 60_000], m)
        db.algo[:m] = rng.integers(0, 2, m)
        db.active[:m] = True
        rounds.append(db)
    return rounds


def snapshot(table):
    return {f: getattr(table, f).numpy().copy() for f in table._fields}


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 4095, 4096])
def test_narrow_send_matches_the_whole_tier_and_the_jax_engine(
        n, frozen_clock, monkeypatch):
    cfg = DeviceConfig(num_slots=SLOTS, ways=WAYS, batch_size=BATCH,
                       platform="cpu")
    be = TorchBackend(cfg, clock=frozen_clock)
    whole = TorchBackend(cfg, clock=frozen_clock).table
    jb = DeviceBackend(JaxDeviceConfig(num_slots=SLOTS, ways=WAYS,
                                       batch_size=BATCH), clock=frozen_clock)
    tiers = resolve_tiers(cfg)
    widths = []
    real_step = backend_mod.persistent_serve_step

    def step(table, qs, *args, **kw):
        widths.append(qs.shape[-1])
        return real_step(table, qs, *args, **kw)

    monkeypatch.setattr(backend_mod, "persistent_serve_step", step)
    rng = np.random.default_rng(n)
    pool = rng.integers(1, 2**62, size=n + n // 2 + 1)
    t = tiers[0] if n <= tiers[0] else tiers[-1]
    a = min(t, -(-n // 128) * 128)
    for step, dt in enumerate(STEPS):
        frozen_clock.advance(dt)
        rounds = call_rounds(rng, pool, n)
        got = be.step_rounds(rounds)

        # The same rounds sent whole at the tier.
        qs = torch.from_numpy(rounds_to_qs(rounds, tiers))
        assert qs.shape[-1] == t
        nows = torch.full((len(rounds),), frozen_clock.millisecond_now(),
                          dtype=torch.int64)
        whole, full, _ = persistent_serve_step(
            whole, qs, nows, torch.zeros((), dtype=torch.int64), WAYS)
        want = jb.step_rounds([JaxDeviceBatch(*db) for db in rounds])
        for r, (g, db) in enumerate(zip(got, rounds)):
            m = int(db.active.sum())
            for i, (col, v) in enumerate(g.items()):
                assert v.shape == (a,), (step, r, col)
                np.testing.assert_array_equal(
                    v, full[r, i, :a].numpy(), err_msg=f"{step} {r} {col}")
                np.testing.assert_array_equal(
                    v[:m], np.asarray(want[r][col])[:m],
                    err_msg=f"jax {step} {r} {col}")
    assert widths == [a] * len(STEPS)
    mine = be.snapshot()
    for f, v in snapshot(whole).items():
        np.testing.assert_array_equal(mine[f], v, err_msg=f)
        np.testing.assert_array_equal(mine[f], np.asarray(jb.snapshot()[f]),
                                      err_msg=f"jax {f}")


def test_occupied_width_is_the_highest_active_lane_over_the_rounds():
    tiers = (128, 4096)

    def rounds(*lanes, width=4096):
        out = []
        for ls in lanes:
            db = empty_batch(width)
            db.active[list(ls)] = True
            db.key_hash[list(ls)] = np.arange(1, len(ls) + 1)
            out.append(db)
        return out

    q = occupied_q(rounds([]), tiers)
    assert q.shape == (1, 12, 128) and not q.any()
    q = occupied_q(rounds(range(200), range(300)), tiers)
    assert q.shape == (2, 12, 384)
    np.testing.assert_array_equal(q[1, 0, :300], np.arange(1, 301))
    assert not q[0, :, 200:].any() and not q[1, :, 300:].any()
    # Lanes need not be contiguous: the highest one sets the width.
    q = occupied_q(rounds([*range(130), 1500]), tiers)
    assert q.shape == (1, 12, 1536) and q[0, 0, 1500] == 131
    # Never wider than the tier, where that is no multiple of 128.
    q = occupied_q(rounds(range(990), width=1000), (128, 1000))
    assert q.shape == (1, 12, 1000) and q[0, 0, 989] == 990
    q = occupied_q(rounds(range(2), width=64), (8, 64))
    assert q.shape == (1, 12, 8) and q[0, 0, 1] == 2


@pytest.mark.parametrize("caller", ["mesh", "global"])
def test_grid_dispatch_and_global_ingest_send_the_whole_tier(
        caller, frozen_clock, monkeypatch):
    """400 requests over two shards, about 200 lanes a shard: the tier is
    1024 while the occupied width would be 256."""
    be = MeshBackend(DeviceConfig(num_slots=SLOTS, ways=WAYS, batch_size=1024,
                                  num_shards=2, platform="cpu"),
                     clock=frozen_clock)
    widths = []
    real_launch = be._launch

    def launch(qs, *a, **kw):
        widths.append(qs.shape[-1])
        return real_launch(qs, *a, **kw)

    monkeypatch.setattr(be, "_launch", launch)
    reqs = [RateLimitReq(name="w", unique_key=f"k{i}", hits=1, limit=5,
                         duration=60_000,
                         behavior=Behavior.GLOBAL if caller == "global"
                         else Behavior.BATCHING)
            for i in range(400)]
    if caller == "mesh":
        host = be.step_rounds(
            pack_requests_sharded(reqs, 1024, 2, frozen_clock).rounds)
        assert {v.shape for v in host[0].values()} == {(2, 1024)}
    else:
        out = GlobalEngine(be).check(reqs)
        assert all(r.error == "" for r in out)
    assert widths == [1024]
