"""The port's persistence (gubernator_tpu_torch/runtime/store.py, the
backend's PersistenceHost, the fast lane's write-through and
runtime/checkpoint.py) against the JAX package's, on the CPU.

The Store/Loader scenarios of tests/test_store.py (store_test.go:45-200)
run on a port service and a JAX service from the same frozen instant:
answers, Store contents, Loader saves and call counts are equal.  The fast
lane keeps a Store on the lane (cold keys repaired after the step,
write-through captured behind it) and gives the JAX lane's bytes, Store
and table.  Checkpoints save in each package and restore in the same
package (the JAX package writes orbax, the port numpy files): the restored
tables, keymaps and sketches are equal across the packages."""
from __future__ import annotations

import asyncio
import os
import random
import threading

import numpy as np
import pytest
import torch

from gubernator_tpu.core import config as jcfg
from gubernator_tpu.core import types as jt
from gubernator_tpu.runtime import store as jstore
from gubernator_tpu.runtime.backend import DeviceBackend
from gubernator_tpu.runtime.service import Service as JaxService
from gubernator_tpu_torch.core import config as pcfg
from gubernator_tpu_torch.core import types as pt
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.runtime import store as pstore
from gubernator_tpu_torch.runtime.backend import TorchBackend
from gubernator_tpu_torch.runtime.service import Service

SLOTS, WAYS, B = 4096, 8, 128
LEAKY = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pkg:
    """One package's names, so a scenario runs unchanged on either."""

    def __init__(self, port: bool) -> None:
        self.port = port
        self.types = pt if port else jt
        self.store = pstore if port else jstore

    def device(self, slots=SLOTS, batch=B):
        if self.port:
            return pcfg.DeviceConfig(num_slots=slots, ways=WAYS,
                                     batch_size=batch, platform="cpu")
        return jcfg.DeviceConfig(num_slots=slots, ways=WAYS, batch_size=batch)

    def service(self, clock, **kw):
        if self.port:
            return Service(pcfg.Config(device=self.device(), **kw),
                           clock=clock)
        return JaxService(jcfg.Config(
            device=self.device(), **kw), clock=clock)

    def backend(self, clock, slots=SLOTS, **kw):
        cls = TorchBackend if self.port else DeviceBackend
        return cls(self.device(slots), clock=clock, **kw)

    def req(self, **kw):
        return self.types.RateLimitReq(**kw)


PORT, JAX = Pkg(True), Pkg(False)


def in_turn(clock, scenario):
    """scenario(pkg) on the port, then on JAX from the same instant."""
    t0 = clock.now_ns()
    got = scenario(PORT)
    clock.freeze(t0)
    return got, scenario(JAX)


def item_tuple(it):
    return (it.key, int(it.algorithm), it.expire_at, it.limit, it.duration,
            float(it.remaining), it.created_at, int(it.status), it.burst)


def resp_tuple(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


def test_loader_load_save_once_matches_jax(frozen_clock):
    """store_test.go:76-125: load at startup, save at shutdown, and a
    restart continues the saved buckets; GLOBAL broadcast rows are never
    saved."""
    def scenario(P):
        async def run(loader, reqs):
            svc = P.service(frozen_clock, loader=loader)
            await svc.start()
            try:
                return [resp_tuple(r) for r in
                        await svc.get_rate_limits(reqs)]
            finally:
                await svc.close()

        loader = P.store.MockLoader()
        first = asyncio.run(run(loader, [
            P.req(name="ld", unique_key=f"u{i}", limit=10, hits=1 + i % 4,
                  duration=60_000, algorithm=i % 2) for i in range(20)]))
        saved = sorted(item_tuple(i) for i in loader.contents)
        frozen_clock.advance(1_500)
        again = asyncio.run(run(P.store.MockLoader(loader.contents), [
            P.req(name="ld", unique_key=f"u{i}", limit=10, hits=1,
                  duration=60_000, algorithm=i % 2) for i in range(20)]))
        return first, saved, again, dict(loader.called)

    got, want = in_turn(frozen_clock, scenario)
    assert got == want
    first, saved, again, called = got
    assert called == {"load": 1, "save": 1} and len(saved) == 20
    assert again[0][2] == 10 - 1 - 1  # u0 continued from the saved 9


def test_store_get_and_on_change_matches_jax(frozen_clock):
    """store_test.go:127-200: Get seeds misses (live items only), OnChange
    sees every post-step state, for both algorithms."""
    def scenario(P):
        T = P.types
        now = frozen_clock.millisecond_now()
        store = P.store.MockStore()
        for i in range(6):
            key = f"st_seed{i}"
            store.data[key] = T.CacheItem(
                key=key, algorithm=T.Algorithm(i % 2),
                expire_at=now + (60_000 if i != 5 else -1), limit=10,
                duration=60_000, remaining=3.5 if i % 2 else 3,
                created_at=now - 1_000, status=T.Status.UNDER_LIMIT)

        async def run():
            svc = P.service(frozen_clock, store=store)
            await svc.start()
            try:
                out = []
                for j in range(4):
                    reqs = [P.req(name="st", unique_key=f"seed{i}",
                                  limit=10, hits=1 + j % 2,
                                  duration=60_000, algorithm=i % 2)
                            for i in range(6)]
                    reqs += [P.req(name="st", unique_key=f"fresh{i}",
                                   limit=5, hits=2, duration=60_000,
                                   algorithm=i % 2) for i in range(3)]
                    out.append([resp_tuple(r) for r in
                                await svc.get_rate_limits(reqs)])
                    frozen_clock.advance(250)
                return out
            finally:
                await svc.close()

        out = asyncio.run(run())
        return out, sorted(item_tuple(v) for v in store.data.values()), \
            dict(store.called)

    got, want = in_turn(frozen_clock, scenario)
    assert got == want
    out, data, called = got
    assert out[0][0][2] == 2       # continued from the stored remaining 3
    assert out[0][5][2] == 9       # the expired stored item is not seeded
    assert called["on_change"] >= 4 * 9


def test_write_through_captures_own_batch_state():
    """on_change reports the state ITS batch produced, never a later
    concurrent batch's: the capture is read back in the same critical
    section as the step and delivered in ticket order."""
    for P in (PORT, JAX):
        seen = []
        lock = threading.Lock()

        class Recording(P.store.Store):
            def get(self, req):
                return None

            def on_change(self, req, item):
                with lock:
                    seen.append(int(item.remaining))

            def remove(self, key):
                pass

        be = P.backend(None, slots=1024, store=Recording())
        req = P.req(name="wt", unique_key="k", hits=1, limit=1000,
                    duration=60_000)
        barrier = threading.Barrier(8)

        def worker():
            barrier.wait()
            for _ in range(5):
                be.check([req])

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert seen == list(range(999, 959, -1)), P.port


def lane_payloads(seed: int, n: int):
    """GetRateLimits payloads over stored, cold and fresh keys with
    duplicates inside a payload (the lane's cascade merge)."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        reqs = []
        for _ in range(rng.randrange(1, 24)):
            k = rng.randrange(16)
            reqs.append(pb.RateLimitReq(
                name="ln", unique_key=f"k{k}", hits=rng.choice([0, 1, 1, 2]),
                limit=12, duration=60_000, algorithm=k % 2))
        out.append(pb.GetRateLimitsReq(requests=reqs).SerializeToString())
    return out


@pytest.mark.parametrize("mode", ["pipelined", "ring"])
def test_fast_lane_with_store_matches_jax_lane(mode, frozen_clock):
    """A Store stays on the compiled lane in both packages: the same raw
    payloads give the same response bytes, Store contents and tables, with
    no fallback to the object path."""
    from gubernator_tpu.runtime.fastpath import FastPath as JaxFastPath
    from gubernator_tpu_torch.runtime.fastpath import FastPath

    payloads = lane_payloads(7, 16)

    def scenario(P):
        T = P.types
        now = frozen_clock.millisecond_now()
        store = P.store.MockStore()
        for k in range(0, 16, 3):  # cold on the device, live in the store
            store.data[f"ln_k{k}"] = T.CacheItem(
                key=f"ln_k{k}", algorithm=T.Algorithm(k % 2),
                expire_at=now + 60_000, limit=12, duration=60_000,
                remaining=5 if k % 2 == 0 else 5.25, created_at=now - 10,
                status=T.Status.UNDER_LIMIT)

        async def run():
            svc = P.service(frozen_clock, store=store)
            lane = (FastPath if P.port else JaxFastPath)(
                svc, serve_mode=mode, ring_slots=2, ring_rounds=2)
            await svc.start()
            try:
                raw = []
                for i, p in enumerate(payloads):
                    raw.append(await lane.check_raw(p, peer_rpc=False))
                    if i % 4 == 3:
                        frozen_clock.advance(300)
                return raw, (lane.served, lane.fallbacks), \
                    svc.backend.snapshot()
            finally:
                await lane.close()
                await svc.close()

        raw, counts, snap = asyncio.run(run())
        return raw, counts, snap, sorted(
            item_tuple(v) for v in store.data.values())

    (raw, counts, snap, data), (jraw, jcounts, jsnap, jdata) = in_turn(
        frozen_clock, scenario)
    assert all(r is not None for r in raw) and raw == jraw
    assert counts == jcounts and counts[0] > 0 and counts[1] == 0
    assert data == jdata and len(data) == 16
    for f in jsnap:
        np.testing.assert_array_equal(snap[f], jsnap[f], err_msg=f)


def checkpoint_scenario(P, clock, directory):
    """Serve a stream on a tracked backend and a sketch, save, restore into
    fresh ones: (restored snapshot, restored live keys, restored sketch
    counters, answers after the restore)."""
    from gubernator_tpu.runtime.checkpoint import TableCheckpointer as JCk
    from gubernator_tpu.runtime.sketch_backend import SketchBackend as JSk
    from gubernator_tpu_torch.runtime.checkpoint import TableCheckpointer
    from gubernator_tpu_torch.runtime.sketch_backend import SketchBackend

    def sketch():
        if P.port:
            return SketchBackend(pcfg.SketchTierConfig(
                names=["ip"], width=2048, window_ms=3_600_000, batch_size=64),
                device="cpu", clock=clock)
        return JSk(jcfg.SketchTierConfig(
            names=["ip"], width=2048, window_ms=3_600_000, batch_size=64),
            clock=clock)

    be, sk = P.backend(clock, track_keys=True), sketch()
    reqs = [P.req(name="ck", unique_key=f"k{i}", hits=1 + i % 5, limit=10,
                  duration=3_600_000, algorithm=i % 2) for i in range(300)]
    be.check(reqs)
    kh = np.arange(1, 41, dtype=np.int64) * 7919
    sk.check_cols(kh, np.full(40, 3, dtype=np.int64),
                  np.full(40, 10, dtype=np.int64))
    ck = (TableCheckpointer if P.port else JCk)(directory)
    ck.save(be, step=1, sketch=sk)
    be2, sk2 = P.backend(clock, track_keys=True), sketch()
    assert (TableCheckpointer if P.port else JCk)(directory).restore(
        be2, sketch=sk2) == 1
    answers = [resp_tuple(r) for r in be2.check(reqs[:50])]
    st, rem, _ = sk2.check_cols(kh, np.full(40, 3, dtype=np.int64),
                                np.full(40, 10, dtype=np.int64))
    return (be2.snapshot(), sorted(i.key for i in be2.live_items()),
            np.asarray(sk2.state.cur).copy(), answers,
            (list(map(int, st)), list(map(int, rem))))


def test_checkpoint_round_trip_in_each_package(frozen_clock, tmp_path):
    got, want = in_turn(frozen_clock, lambda P: checkpoint_scenario(
        P, frozen_clock, str(tmp_path / ("port" if P.port else "jax"))))
    snap, keys, cur, answers, sk = got
    for f in want[0]:
        np.testing.assert_array_equal(snap[f], want[0][f], err_msg=f)
    assert keys == want[1] and len(keys) == 300
    np.testing.assert_array_equal(cur, want[2])
    assert answers == want[3] and sk == want[4]
    assert int(cur.sum()) > 0


def test_checkpoint_steps_prune_crash_leftovers_and_geometry(tmp_path):
    """Steps are directories of .npy files and JSON renamed into place: a
    leftover temporary directory from a crash mid-save is ignored, old
    steps prune, and a checkpoint of another slot count is refused."""
    from gubernator_tpu_torch.runtime.checkpoint import TableCheckpointer

    be = PORT.backend(None)
    be.check([PORT.req(name="p", unique_key="x", hits=1, limit=5,
                       duration=60_000)])
    ck = TableCheckpointer(str(tmp_path))
    os.makedirs(tmp_path / "step_000000000009.tmp-1-deadbeef")
    for s in (1, 2, 3, 4, 5):
        ck.save(be, step=s, keep=2)
    assert ck.latest_step() == 5
    steps = sorted(d.name for d in tmp_path.iterdir()
                   if d.name.startswith("step_") and "tmp" not in d.name)
    assert steps == ["step_000000000004", "step_000000000005"]
    files = sorted(os.listdir(tmp_path / steps[-1] / "table"))
    assert len(files) == 12 and all(f.endswith(".npy") for f in files)
    assert ck.last_save["bytes"] == sum(
        a.nbytes for a in be.snapshot().values())
    with pytest.raises(ValueError, match="slots"):
        ck.restore(PORT.backend(None, slots=2048))


def test_checkpoint_loader_and_periodic_loop(frozen_clock, tmp_path):
    """The Loader adapter (the JAX package's OrbaxLoader) restores at
    attach and checkpoints at save; a changed sketch geometry is skipped.
    The periodic loop writes a step per tick and a final one at stop."""
    from gubernator_tpu_torch.runtime.checkpoint import (
        CheckpointLoader,
        PeriodicCheckpointLoop,
    )
    from gubernator_tpu_torch.runtime.sketch_backend import SketchBackend

    def sketch(width, window):
        return SketchBackend(pcfg.SketchTierConfig(
            names=["ip"], width=width, window_ms=window, batch_size=64),
            device="cpu", clock=frozen_clock)

    be, sk = PORT.backend(frozen_clock), sketch(2048, 3_600_000)
    sk.check_cols(np.array([111, 222], dtype=np.int64),
                  np.array([5, 2], dtype=np.int64),
                  np.array([10, 10], dtype=np.int64))
    ld = CheckpointLoader(str(tmp_path / "ld"))
    ld.attach(be, sketch=sk)
    ld.save(iter([]))
    sk2 = sketch(2048, 3_600_000)
    CheckpointLoader(str(tmp_path / "ld")).attach(PORT.backend(frozen_clock),
                                                  sketch=sk2)
    assert torch.equal(sk2.state.cur, sk.state.cur)
    sk3 = sketch(4096, 60_000)
    CheckpointLoader(str(tmp_path / "ld")).attach(PORT.backend(frozen_clock),
                                                  sketch=sk3)
    assert int(sk3.state.cur.sum()) == 0
    assert int(sk3.state.window_ms) == 60_000

    async def loop():
        lp = PeriodicCheckpointLoop(be, str(tmp_path / "loop"),
                                    interval_s=0.05, keep=10)
        lp.start()
        await asyncio.sleep(0.4)
        await lp.stop()
        return lp.ckptr

    ckptr = asyncio.run(loop())
    assert ckptr.latest_step() >= 3
    be3 = PORT.backend(frozen_clock)
    ckptr.restore(be3)
    for f, a in be.snapshot().items():
        np.testing.assert_array_equal(be3.snapshot()[f], a, err_msg=f)


def test_reset_remaining_leaves_the_store_stale_in_both(frozen_clock):
    """RESET_REMAINING clears the key's row and answers a full bucket, but
    calls neither Store.remove nor Store.on_change, so the next check
    re-seeds the pre-reset counter from the Store (ROADMAP queue 3; the
    reference removes the item from the Store).  The port reproduces the
    JAX package exactly, on the object path and on the compiled lane."""
    from gubernator_tpu.runtime.fastpath import FastPath as JaxFastPath
    from gubernator_tpu_torch.runtime.fastpath import FastPath

    def payload(behavior):
        return pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
            name="rp", unique_key="k", hits=1, limit=1000, duration=60_000,
            behavior=behavior)]).SerializeToString()

    def scenario(P):
        T = P.types
        out = []
        for lane in (False, True):
            now = frozen_clock.millisecond_now()
            store = P.store.MockStore()
            store.data["rp_k"] = T.CacheItem(
                key="rp_k", algorithm=T.Algorithm.TOKEN_BUCKET,
                expire_at=now + 3_600_000, limit=1000, duration=60_000,
                remaining=500, created_at=now - 1_000,
                status=T.Status.UNDER_LIMIT)

            async def run():
                svc = P.service(frozen_clock, store=store)
                fp = (FastPath if P.port else JaxFastPath)(
                    svc, serve_mode="pipelined") if lane else None
                await svc.start()
                try:
                    seen = []
                    for behavior in (0, 8, 0):  # hit, reset, hit
                        if lane:
                            r = pb.GetRateLimitsResp.FromString(
                                await fp.check_raw(payload(behavior),
                                                   peer_rpc=False)
                            ).responses[0]
                        else:
                            r = (await svc.get_rate_limits([P.req(
                                name="rp", unique_key="k", hits=1,
                                limit=1000, duration=60_000,
                                behavior=behavior)]))[0]
                        row = svc.backend.get_cache_item("rp_k")
                        seen.append((int(r.status), r.remaining,
                                     row and float(row.remaining),
                                     float(store.data["rp_k"].remaining)))
                    return seen
                finally:
                    if fp is not None:
                        await fp.close()
                    await svc.close()

            out.append((asyncio.run(run()), dict(store.called)))
        return out

    got, want = in_turn(frozen_clock, scenario)
    assert got == want
    for seen, called in got:
        assert seen == [(0, 499, 499.0, 499.0), (0, 1000, None, 499.0),
                        (0, 498, 498.0, 498.0)]
        assert called["remove"] == 0
