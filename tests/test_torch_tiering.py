"""The port's cold tier (gubernator_tpu_torch/runtime/coldtier.py over the
backend's demote_extract_dispatch / migrate_inject_dispatch) against the
JAX package's, on the CPU.

The scenarios of tests/test_tiering.py run on both packages from one
frozen instant: the rows a demote picks and clears, the cold store's
membership and drops, the watermark drain with the sketch's second
opinion, the demote -> touch -> promote cycle against the pymodel bound,
a promote whose inject fails, the ring-mode request path, a checkpoint of
both tiers, and the daemon's `tier` block.  Answers, rows and counters are
equal."""
from __future__ import annotations

import asyncio

import aiohttp
import numpy as np
import pytest
import torch

from gubernator_tpu.core import config as jcfg
from gubernator_tpu.core import types as jt
from gubernator_tpu.runtime import coldtier as jtier
from gubernator_tpu.runtime.backend import DeviceBackend
from gubernator_tpu.runtime.service import Service as JaxService
from gubernator_tpu_torch.core import config as pcfg
from gubernator_tpu_torch.core import types as pt
from gubernator_tpu_torch.core.hashing import bulk_key_hash64
from gubernator_tpu_torch.runtime import coldtier as ptier
from gubernator_tpu_torch.runtime.backend import TorchBackend
from gubernator_tpu_torch.runtime.service import Service

LIMIT, DURATION = 100, 60_000
SLOTS, WAYS, B = 2048, 8, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pkg:
    def __init__(self, port: bool) -> None:
        self.port = port
        self.types = pt if port else jt
        self.tier = ptier if port else jtier
        self.cfg = pcfg if port else jcfg

    def device(self, slots=SLOTS):
        if self.port:
            return pcfg.DeviceConfig(num_slots=slots, ways=WAYS,
                                     batch_size=B, platform="cpu")
        return jcfg.DeviceConfig(num_slots=slots, ways=WAYS, batch_size=B)

    def backend(self, clock, slots=SLOTS):
        return (TorchBackend if self.port else DeviceBackend)(
            self.device(slots), clock=clock)

    def service(self, clock):
        if self.port:
            return Service(pcfg.Config(device=self.device()), clock=clock)
        return JaxService(jcfg.Config(
            device=self.device()), clock=clock)

    def tier_cfg(self, **kw):
        return self.cfg.TierConfig(enabled=True, **kw)

    def req(self, key, hits=1, limit=LIMIT, **kw):
        return self.types.RateLimitReq(name="t", unique_key=key, hits=hits,
                                       limit=limit, duration=DURATION, **kw)


PORT, JAX = Pkg(True), Pkg(False)


class StubService:
    """The slice of Service a TierManager consumes in unit tests."""

    def __init__(self, backend) -> None:
        self.backend = backend
        self.tier = None

    def derived_slot_fps(self) -> np.ndarray:
        return np.zeros(0, dtype=np.int64)


def in_turn(clock, scenario):
    t0 = clock.now_ns()
    got = scenario(PORT)
    clock.freeze(t0)
    return got, scenario(JAX)


def fps_of(P, reqs) -> np.ndarray:
    return bulk_key_hash64([r.hash_key() for r in reqs])


def item_tuple(it):
    if it is None:
        return None
    return (it.key, int(it.algorithm), it.expire_at, it.limit, it.duration,
            float(it.remaining), it.created_at, int(it.status), it.burst)


def assert_same(got, want):
    """Equal nested results; numpy arrays compared element-wise."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_same(a, b)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want)
    else:
        assert got == want


def test_demote_extract_picks_coldest_and_clears_like_jax(frozen_clock):
    """Three waves of distinct stamps, one protected fingerprint: the
    extract takes the coldest unprotected rows in the JAX order (ties by
    slot), clears them in the same dispatch, and later extracts drain the
    rest and then nothing."""
    def scenario(P):
        be = P.backend(frozen_clock)
        waves = []
        for w in range(3):
            reqs = [P.req(f"w{w}k{i}") for i in range(8)]
            be.check(reqs)
            waves.append(reqs)
            frozen_clock.advance(1000)
        protect = np.zeros(8, dtype=np.int64)
        protect[0] = fps_of(P, waves[0][:1])[0]
        out = []
        for batch in (8, 64, 64):
            packed, rf = be.demote_extract_dispatch(protect, batch=batch)()
            out.append((packed, rf, be.occupancy()))
        return out, be.snapshot(), protect[0]

    got, want = in_turn(frozen_clock, scenario)
    assert_same(got, want)
    (first, second, third), _, protected = got
    assert int((first[0][0] != 0).sum()) == 8
    assert protected not in first[0][0]
    assert int((second[0][0] != 0).sum()) == 15 and third[2] == 1
    assert (first[0][5][first[0][0] != 0] == LIMIT - 1).all()


def test_demote_inject_round_trip_bit_identity(frozen_clock):
    """Demote -> cold store -> promote of untouched keys restores every
    field of token and leaky rows, and the rows keep counting."""
    def scenario(P):
        be = P.backend(frozen_clock)
        reqs = [P.req(f"tok{i}", hits=3 + i) for i in range(3)] + [
            P.req(f"leak{i}", hits=2 + i,
                  algorithm=P.types.Algorithm.LEAKY_BUCKET)
            for i in range(3)]
        be.check(reqs)
        before = [item_tuple(be.get_cache_item(r.hash_key())) for r in reqs]
        packed, rf = be.demote_extract_dispatch(
            np.zeros(8, dtype=np.int64), batch=8)()
        cold = P.tier.ColdTier(capacity=64)
        idx = np.flatnonzero(packed[0] != 0)
        put = cold.put_rows(P.tier.TierManager._cols_from_packed(
            packed, rf, idx))
        counts = be.migrate_inject_dispatch(cold.pop_rows(packed[0][idx]))()
        after = [item_tuple(be.get_cache_item(r.hash_key())) for r in reqs]
        resp = be.check([P.req("tok0", hits=1)])[0]
        return before, after, put, counts, resp.remaining

    got, want = in_turn(frozen_clock, scenario)
    assert got == want
    before, after, put, counts, remaining = got
    assert before == after and put == 6 and counts == (6, 0)
    assert remaining == LIMIT - 3 - 1


def test_cold_store_policy_matches_jax():
    """Open addressing, membership, overwrite, tombstone compaction,
    capacity drops, expiry pruning and a geometry-independent
    snapshot/restore give the same answers in both packages."""
    def rows(fps, remaining=7, expire_at=10_000):
        n = len(fps)
        return {"key_hash": np.asarray(fps, dtype=np.int64),
                "algo": np.zeros(n, dtype=np.int32),
                "limit": np.full(n, LIMIT, dtype=np.int64),
                "duration": np.full(n, DURATION, dtype=np.int64),
                "remaining": np.full(n, remaining, dtype=np.int64),
                "remaining_f": np.zeros(n, dtype=np.float64),
                "t0": np.full(n, 5, dtype=np.int64),
                "status": np.zeros(n, dtype=np.int32),
                "burst": np.full(n, LIMIT, dtype=np.int64),
                "expire_at": np.full(n, expire_at, dtype=np.int64)}

    def scenario(P):
        ct = P.tier.ColdTier(capacity=100)
        out = [ct.put_rows(rows(np.arange(1, 61))),
               ct.put_rows(rows(np.arange(50, 71), remaining=3)),
               ct.member_hits(np.arange(0, 80)).copy()]
        popped = ct.pop_rows(np.arange(1, 41))
        out += [dict(popped), ct.residents()]
        out.append(ct.put_rows(rows(np.arange(1000, 1200), expire_at=50)))
        out += [ct.residents(), ct.capacity_drops, ct.prune_expired(60),
                ct.residents()]
        snap = ct.snapshot()
        ct2 = P.tier.ColdTier(capacity=500)
        # A snapshot's row order follows the home slots, which the port
        # spreads (see the next test): compare rows sorted by fingerprint.
        order = np.argsort(snap["key_hash"])
        out += [{f: v[order] for f, v in snap.items()}, ct2.restore(snap),
                ct2.member_hits(np.arange(0, 80)).copy()]
        return out

    assert_same(scenario(PORT), scenario(JAX))


def test_cold_store_spreads_a_demotion_in_slot_order():
    """A demotion of tied rows arrives in slot order, so its fingerprints
    share their low bits.  The JAX package's home slot (`fp & mask`)
    packs them into one probe cluster, and each insert walks it (ROADMAP
    queue 3); the port's Fibonacci home slot keeps probes short.  Both
    stores hold the same rows and answer the same membership."""
    rng = np.random.default_rng(5)
    n = 3000
    # Five rows from each of the first 600 buckets of a 1024-bucket table:
    # the low 10 bits are the bucket, the rest random.
    fps = (rng.integers(1, 1 << 40, n) << 10) | np.repeat(np.arange(600), 5)

    def probe_lengths(P):
        ct = P.tier.ColdTier(capacity=n)
        rows = {f: np.zeros(n, dtype=ptier._DTYPES[f])
                for f in ptier.COLD_FIELDS}
        rows["key_hash"] = fps
        assert ct.put_rows(rows) == n
        slots = np.flatnonzero(ct._state == 1)
        home = np.array([ct._find(int(f))[0] for f in fps])  # found slot
        keys = ct.cols["key_hash"][slots]
        assert sorted(keys.tolist()) == sorted(fps.tolist())
        assert ct.member_hits(fps).all()
        if P.port:
            start = np.array([((int(f) & ptier._U64) * ptier._GOLDEN
                               & ptier._U64) >> ct._shift for f in fps])
        else:
            start = fps & ct._mask
        return (home - start) & ct._mask

    port, jax = probe_lengths(PORT), probe_lengths(JAX)
    assert port.max() < 64 and port.mean() < 2
    assert jax.mean() > 50  # the cluster the port avoids


def test_watermark_drain_and_sketch_second_opinion(frozen_clock):
    """The hysteresis drains to the low mark over several passes; rows the
    manager's sketch knows are hot go straight back to the device."""
    def scenario(P):
        out = []
        for hot in (False, True):
            be = P.backend(frozen_clock, slots=128)
            tm = P.tier.TierManager(StubService(be), P.tier_cfg(
                cold_capacity=256, high_water=0.6, low_water=0.4,
                demote_batch=16 if not hot else 128, interval_s=1.0))
            reqs = [P.req(f"f{i}") for i in range(100)]
            be.check(reqs[:50])
            be.check(reqs[50:])
            fps = fps_of(P, reqs)
            if hot:
                tm.cms.update(fps[:30], np.full(30, 1000, dtype=np.int64))
            occ = be.occupancy()
            need = tm.demote_need(occ)
            out.append((occ, need, tm.demote_once_sync(), be.occupancy(),
                        tm.cold.residents(), tm.demotes, tm.demote_passes,
                        tm.demote_once_sync(),
                        tm.cold.member_hits(fps).copy(), be.snapshot()))
        return out

    got, want = in_turn(frozen_clock, scenario)
    assert_same(got, want)
    (occ, need, demoted, occ1, res, *_), hot = got
    assert demoted == need > 16 and occ1 == int(0.4 * 128) == occ - need
    assert not hot[8][:30].any() and hot[8][30:].sum() == hot[1]


@pytest.mark.parametrize("consumed,touch", [(4, 5), (8, 5), (10, 10)])
def test_tier_cycle_bound_and_merge(consumed, touch, frozen_clock):
    """Demote -> touch while cold (a fresh row serves) -> promote merges
    the cold budget back by the inject algebra: remaining is
    max(cold_remaining - touch, 0) and the cycle over-admits at most one
    limit window."""
    limit = 10

    def scenario(P):
        async def run():
            svc = P.service(frozen_clock)
            tm = P.tier.TierManager(svc, P.tier_cfg(
                cold_capacity=4096, high_water=0.6, low_water=0.4,
                demote_batch=64, interval_s=1.0))
            svc.tier = tm
            await svc.start()
            frozen_clock.advance(5)  # the warmup row expires
            try:
                out = [(await svc.get_rate_limits(
                    [P.req("k", hits=consumed, limit=limit)]))[0]]
                packed, rf = svc.backend.demote_extract_dispatch(
                    np.zeros(8, dtype=np.int64), batch=8)()
                idx = np.flatnonzero(packed[0] != 0)
                tm.cold.put_rows(P.tier.TierManager._cols_from_packed(
                    packed, rf, idx))
                out.append((await svc.get_rate_limits(
                    [P.req("k", hits=touch, limit=limit)]))[0])
                promoted = tm.drain_promotes_sync()
                item = svc.backend.get_cache_item("t_k")
                for h in (int(item.remaining), 1):
                    if h:
                        out.append((await svc.get_rate_limits(
                            [P.req("k", hits=h, limit=limit)]))[0])
                return ([(int(r.status), r.remaining, r.reset_time)
                         for r in out], len(idx), promoted,
                        item_tuple(item), tm.cold_hits, tm.promotes)
            finally:
                await svc.close()

        return asyncio.run(run())

    got, want = in_turn(frozen_clock, scenario)
    assert got == want
    resps, n_demoted, promoted, item, cold_hits, promotes = got
    expect = max(limit - consumed - touch, 0)
    assert n_demoted == 1 and promoted == promotes == 1 and cold_hits >= 1
    assert item[5] == expect and resps[-1][0] == 1  # then OVER_LIMIT
    admitted = consumed + touch + expect
    assert limit <= admitted <= 2 * limit


def test_promote_failure_conserves_rows_back_to_cold(frozen_clock):
    """An inject that keeps failing retries once, then puts the rows back
    in the cold store; the next access promotes them."""
    def scenario(P):
        async def run():
            svc = P.service(frozen_clock)
            tm = P.tier.TierManager(svc, P.tier_cfg(
                cold_capacity=4096, high_water=0.6, low_water=0.4,
                demote_batch=64, interval_s=1.0))
            svc.tier = tm
            await svc.start()
            frozen_clock.advance(5)
            try:
                await svc.get_rate_limits([P.req("k", hits=4)])
                packed, rf = svc.backend.demote_extract_dispatch(
                    np.zeros(8, dtype=np.int64), batch=8)()
                idx = np.flatnonzero(packed[0] != 0)
                fp = np.array([packed[0][idx][0]], dtype=np.int64)
                tm.cold.put_rows(P.tier.TierManager._cols_from_packed(
                    packed, rf, idx))

                def boom(cols):
                    raise RuntimeError("injected inject failure")

                orig = svc.backend.migrate_inject_dispatch
                svc.backend.migrate_inject_dispatch = boom
                try:
                    tm.note_access(fp, np.ones(1, dtype=np.int64))
                    with pytest.raises(RuntimeError):
                        tm.drain_promotes_sync()
                finally:
                    svc.backend.migrate_inject_dispatch = orig
                kept = bool(tm.cold.member_hits(fp).all())
                tm.note_access(fp, np.ones(1, dtype=np.int64))
                return (tm.promote_retries, tm.promote_failures, kept,
                        tm.drain_promotes_sync(), tm.cold.residents(),
                        item_tuple(svc.backend.get_cache_item("t_k")))
            finally:
                await svc.close()

        return asyncio.run(run())

    got, want = in_turn(frozen_clock, scenario)
    assert got == want
    assert got[:5] == (1, 1, True, 1, 0) and got[5][5] == LIMIT - 4


def test_tier_ring_request_path_fetch_free(frozen_clock):
    """A whole tier cycle in ring mode rides the ring's host-job lane: the
    fast lane's blocking-fetch ledger does not move, and the merged row
    continues the window."""
    from gubernator_tpu.runtime.fastpath import FastPath as JaxFastPath
    from gubernator_tpu_torch.runtime.fastpath import FastPath

    def scenario(P):
        async def run():
            svc = P.service(frozen_clock)
            await svc.start()
            frozen_clock.advance(5)
            fp = (FastPath if P.port else JaxFastPath)(
                svc, serve_mode="ring", ring_slots=2)
            tm = P.tier.TierManager(svc, P.tier_cfg(
                cold_capacity=4096, high_water=0.6, low_water=0.4,
                demote_batch=64, interval_s=1.0), fastpath=fp)
            svc.tier = tm
            try:
                reqs = [P.req(f"k{i}", hits=3) for i in range(12)]
                await svc.get_rate_limits(reqs)
                before = dict(fp.blocking_fetches)
                packed, rf = tm._run_job(
                    lambda: svc.backend.demote_extract_dispatch(
                        tm._protect_grid(), 16))()
                idx = np.flatnonzero(packed[0] != 0)
                tm.cold.put_rows(P.tier.TierManager._cols_from_packed(
                    packed, rf, idx))
                resps = await svc.get_rate_limits(
                    [P.req(f"k{i}", hits=1) for i in range(12)])
                out = ([(int(r.status), r.remaining) for r in resps],
                       len(idx), tm.cold_hits, tm.drain_promotes_sync(),
                       item_tuple(svc.backend.get_cache_item("t_k0")),
                       fp.effective_serve_mode)
                assert fp.blocking_fetches == before
                return out
            finally:
                await fp.close()
                await svc.close()

        return asyncio.run(run())

    got, want = in_turn(frozen_clock, scenario)
    assert got == want
    assert got[1] == 12 and got[3] == 12 and got[5] == "ring"
    assert got[4][5] == LIMIT - 4


def test_checkpoint_round_trip_both_tiers(frozen_clock, tmp_path):
    """A split state (hot rows on the device, cold rows in the cold store)
    checkpoints and restores into another cold geometry; a restored cold
    key continues its window."""
    from gubernator_tpu.runtime.checkpoint import TableCheckpointer as JCk
    from gubernator_tpu_torch.runtime.checkpoint import TableCheckpointer

    def scenario(P):
        Ck = TableCheckpointer if P.port else JCk
        be = P.backend(frozen_clock)
        hot = [P.req(f"hot{i}", hits=2 + i) for i in range(4)]
        colds = [P.req(f"cold{i}", hits=5) for i in range(6)]
        be.check(hot + colds)
        cold_fps = fps_of(P, colds)
        packed, rf = be.demote_extract_dispatch(
            np.zeros(8, dtype=np.int64), batch=16)()
        all_idx = np.flatnonzero(packed[0] != 0)
        cold_mask = np.isin(packed[0], cold_fps)
        ct = P.tier.ColdTier(capacity=64)
        ct.put_rows(P.tier.TierManager._cols_from_packed(
            packed, rf, np.flatnonzero(cold_mask)))
        be.migrate_inject_dispatch(P.tier.TierManager._cols_from_packed(
            packed, rf, np.setdiff1d(all_idx, np.flatnonzero(cold_mask))))()
        d = str(tmp_path / ("port" if P.port else "jax"))
        Ck(d).save(be, step=1, coldtier=ct)
        be2, ct2 = P.backend(frozen_clock), P.tier.ColdTier(capacity=500)
        step = Ck(d).restore(be2, coldtier=ct2)
        out = [step, be2.occupancy(), ct2.residents(),
               [item_tuple(be2.get_cache_item(r.hash_key())) for r in hot],
               be2.migrate_inject_dispatch(ct2.pop_rows(cold_fps[:1]))(),
               be2.check([P.req("cold0", hits=1)])[0].remaining]
        return out, be2.snapshot()

    got, want = in_turn(frozen_clock, scenario)
    assert_same(got, want)
    assert got[0][:3] == [1, 4, 6] and got[0][4] == (1, 0)
    assert got[0][5] == LIMIT - 6


def test_daemon_tier_block_matches_jax(frozen_clock):
    """GUBER_TIER_ENABLED arms the tier in the daemon: its manager serves
    `/debug/vars`' `tier` block, the object path promotes a cold key on
    access, and the block's counters equal the JAX daemon's."""
    from gubernator_tpu import daemon as jdaemon
    from gubernator_tpu_torch import daemon as pdaemon

    def scenario(P):
        async def run():
            common = dict(
                grpc_listen_address="127.0.0.1:0",
                http_listen_address="127.0.0.1:0",
                behaviors=P.cfg.fast_test_behaviors(),
                tier=P.tier_cfg(cold_capacity=512, high_water=0.6,
                                low_water=0.4, demote_batch=32,
                                interval_s=60.0),
                stats=P.cfg.StatsConfig(enabled=False))
            if P.port:
                conf = pcfg.DaemonConfig(device=P.device(128), **common)
            else:
                conf = jcfg.DaemonConfig(device=P.device(128), **common)
            d = (pdaemon if P.port else jdaemon).Daemon(conf,
                                                        clock=frozen_clock)
            await d.start()
            frozen_clock.advance(5)
            try:
                svc = d.service
                await svc.get_rate_limits(
                    [P.req(f"f{i}", hits=2) for i in range(100)])
                loop = asyncio.get_running_loop()
                # Stop the tier's worker so the promote lands when this
                # test drains it, not in a race with the serving step.
                await loop.run_in_executor(None, d.tier.close)
                demoted = await loop.run_in_executor(
                    None, d.tier.demote_once_sync)
                cold = [i for i in range(100) if d.tier.cold.member_hits(
                    fps_of(P, [P.req(f"f{i}")])).all()]
                resp = (await svc.get_rate_limits(
                    [P.req(f"f{cold[0]}", hits=1)]))[0]
                promoted = await loop.run_in_executor(
                    None, d.tier.drain_promotes_sync)
                async with aiohttp.ClientSession() as s:
                    async with s.get(
                            f"http://{d.http_address}/debug/vars") as r:
                        block = (await r.json())["tier"]
                block.pop("promote_latency")
                item = svc.backend.get_cache_item(f"t_f{cold[0]}")
                return (demoted, len(cold), resp.remaining, promoted,
                        item_tuple(item), block)
            finally:
                await d.close()

        return asyncio.run(run())

    got, want = in_turn(frozen_clock, scenario)
    assert got == want
    demoted, n_cold, remaining, promoted, item, block = got
    assert demoted == n_cold > 0 and promoted == 1
    assert remaining == LIMIT - 1 and item[5] == LIMIT - 2 - 1
    assert block["demotes"] == demoted and block["promotes"] == 1


def test_compiled_lane_promotes_a_demoted_key_under_defaults(frozen_clock):
    """GUBER_TIER_ENABLED=true with every other plane at its default (hot
    keys on in both packages): a demoted key checked through the compiled
    lane answers from a fresh row, and the lane's note_traffic queues the
    promote that merges the cold row's consumption, so the served row then
    holds the cold consumption plus the new hits, as in the JAX daemon."""
    import grpc

    from gubernator_tpu import daemon as jdaemon
    from gubernator_tpu_torch import daemon as pdaemon
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    def wire(keys, hits):
        return pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
            name="t", unique_key=k, hits=hits, limit=LIMIT,
            duration=DURATION) for k in keys]).SerializeToString()

    def scenario(P):
        async def run():
            conf = P.cfg.DaemonConfig(
                grpc_listen_address="127.0.0.1:0",
                http_listen_address="127.0.0.1:0",
                behaviors=P.cfg.fast_test_behaviors(),
                device=P.device(128),
                tier=P.tier_cfg(cold_capacity=512, high_water=0.6,
                                low_water=0.4, demote_batch=32,
                                interval_s=60.0))
            assert conf.hotkey.enabled and conf.lease.enabled
            d = (pdaemon if P.port else jdaemon).Daemon(conf,
                                                        clock=frozen_clock)
            await d.start()
            frozen_clock.advance(5)
            try:
                async with grpc.aio.insecure_channel(d.grpc_address) as ch:
                    call = ch.unary_unary("/pb.gubernator.V1/GetRateLimits")
                    await call(wire([f"f{i}" for i in range(100)], 3))
                    loop = asyncio.get_running_loop()
                    await loop.run_in_executor(None, d.tier.close)
                    demoted = await loop.run_in_executor(
                        None, d.tier.demote_once_sync)
                    cold = [i for i in range(100) if d.tier.cold.member_hits(
                        fps_of(P, [P.req(f"f{i}")])).all()]
                    served = d.fastpath.served
                    first = pb.GetRateLimitsResp.FromString(
                        await call(wire([f"f{cold[0]}"], 2))).responses[0]
                    lane = d.fastpath.served - served
                    promoted = await loop.run_in_executor(
                        None, d.tier.drain_promotes_sync)
                    merged = item_tuple(d.service.backend.get_cache_item(
                        f"t_f{cold[0]}"))
                    second = pb.GetRateLimitsResp.FromString(
                        await call(wire([f"f{cold[0]}"], 1))).responses[0]
                return (demoted, len(cold), lane, promoted, first.remaining,
                        merged, second.remaining)
            finally:
                await d.close()

        return asyncio.run(run())

    got, want = in_turn(frozen_clock, scenario)
    assert got == want
    demoted, n_cold, lane, promoted, first, merged, second = got
    assert demoted == n_cold > 0 and lane == 1 and promoted == 1
    # The fresh row answers first; the promote merges the cold row's 3.
    assert first == LIMIT - 2
    assert merged[5] == LIMIT - 3 - 2 and second == LIMIT - 3 - 2 - 1
