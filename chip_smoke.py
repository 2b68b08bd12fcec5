#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of gubernator on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build both kernels (csrc/serve_kernel.cu, csrc/cms_kernel.cu) with
     nvcc, in parallel, and print ptxas' registers and spills;
  2. run K1, the serve kernel, and its plain PyTorch version
     (ops/ring.ring_step) on seeded random tables and rounds that reach
     every branch of the decision step, and require them bit-exact: more
     owner blocks than buckets, a round whose every lane lands in one
     owner's buckets, and more lanes than the card has threads;
  3. warm a 2^24-slot table to 10M live keys through K1;
  4. serve 8 check() batches of 32768 string-keyed requests (token and
     leaky, with duplicates) through TorchBackend, require one K1 launch
     per check(), hold every launch's responses (all lanes), every
     check() response and the final table bit-exact against the plain
     version run on a copy of the table, and require the claim words
     restored;
  5. time K1 and the plain version with CUDA events (L2 flushed before
     each call), split check()'s host time, trace one check() with
     torch.profiler for the device's busy time;
  6. run K2, the sketch merge kernel, and its plain version
     (ops/sketch.multi_step) on seeded sketches and merges from
     gubernator_tpu_torch/testing.py (W from 2^10 to 2^20, k = 1 and 32,
     B = 1024, 1025 and more lanes than the grid has threads) in every
     window case, and one key across 32 chunks of a 2^4 sketch, and
     require packed outputs and both tables bit-exact;
  7. set up the sketch tier at the repo's 100M-key deployment (D = 4,
     W = 2^20, 60 s window, batch 1024) on the card and warm its window
     through K2 with 48M hits over a 100M-key space (~46 counts a cell);
  8. serve 16 check() calls of 32768 string-keyed requests (1% of lanes on
     64 hot keys with limit 100) while a frozen clock steps through
     in-window, sliding, one-behind and far-behind rotations; require one
     K2 launch per check(), and hold every launch's packed outputs, every
     RateLimitResp and the final sketch bit-exact against the plain
     version run on a copy;
  9. time K2 and its plain version (L2 flushed) at the main path's shape,
     at k = 1, on a merge that rolls and at the warm-up's shape, split the
     sketch check()'s host time, and trace one check();
 10. start the port's daemon at full width on the card (2^24 slots,
     batch 32768, the sketch tier at the 100M-key deployment), warm its
     table to 10M live keys through K1, and in the pipelined and the
     persistent serve modes send 64 concurrent gRPC clients' sequential
     GetRateLimits of 1000 requests (1/8 on the sketch name); record every
     K1 and K2 dispatch and replay them through the plain versions on
     copies of the starting table and sketch (bit-exact outputs, table,
     sketch, claim words), drive a control key past its limit on the wire,
     require no fast-lane fallback (and in persistent mode no ring
     sequence mismatch and no blocking fetch), time decisions/s and
     per-RPC latency, and trace about a second of persistent serving with
     torch.profiler;
 11. the same in the classic, ring and megaround modes on a 2^20-slot
     daemon with fewer RPCs; then a 3-node in-process cluster answers a
     stream through node 0 exactly as a single node does (owner metadata
     aside), and GLOBAL keys hit through a non-owner are answered; print
     the kernel line (K1 and K2), the card, and the result line;
 12. persistence at full width: checkpoint phase 10's persistent daemon
     (table and sketch) with TableCheckpointer, restore it into a fresh
     daemon (byte-equal table and sketch, byte-equal answers to 8 RPCs);
     a pipelined 2^24-slot daemon restored from a MockLoader of 1M items
     and serving 64 clients x 3 RPCs over Loader keys and cold MockStore
     keys on the compiled lane (every touched key's Store row equals the
     table's; the Loader's save at close is every live tracked bucket
     row);
 13. the state plane at full width: table_stats on phase 10's warmed
     table against a numpy census and the sampler's /debug/vars block,
     /debug/key of the control key, each state-plane op timed against
     its byte bound, the cold tier demoting ~2.7M rows to its low mark
     and promoting 65,536 back, and a 2 -> 3-node reshard of 1M live
     keys at 2^24 slots a node, its transfer deadline raised from 10 s
     to 120 s (no row lost, moved rows equal, the old owners purged,
     1000 checks through node 0 answer as the plain step on CPU copies of
     the old owners' rows).  Every K1/K2 dispatch of phases 12-13 replays
     through the plain versions; the first, second and latest dispatch
     of each state-plane op replays on CPU copies of its inputs; the
     state-plane line (ms, launches per path, bound) precedes the kernel
     line.
 14. the hot-key and lease planes at full width: a 3-node pipelined
     cluster at 2^24 slots a node, each warmed through K1 to 1M live keys;
     two LeasedClients and a V1Client admit exactly 100 x (1 + 2 x 0.25)
     of one key; 64 LeasedClients over 1000 keys each run 20 checks a key
     (checks/s, RPCs per 1000 checks, Lease RPC p50/p99) and every owner
     row then holds every hit; a pressured owner's hot key promotes on its
     next-arc mirror, which serves it on the compiled lane's serve_mirror
     split within exactly limit x (1 + mirrors x fraction), and collapses
     when the pressure clears; a seeded chaos partition between a holder's
     daemon and the owner keeps admission under the closed-form bound, and
     the burned hits reconcile exactly once after the heal.  Every K1
     dispatch of the phase replays through the plain version.
 15. regions, gossip and the load generator at full width: four daemons,
     two in each of the regions east and west, at 2^24 slots a node, find
     each other by gossip on 127.0.0.1 from one seed (no static peers);
     the port's load generator, through its runner and report, checks 1024
     west-homed keys from east 35 times each (limit 100, fraction 0.25) in
     batches of 1000 beside a background load on east-homed keys: every
     key admits exactly 25 in east, every west home row then reads exactly
     25 used, nothing drifts or drops, and the report says `cuda`; a chaos
     partition of east from west admits nothing past a carve, requeues the
     burns and applies them once after the heal.  Every K1 dispatch of the
     phase replays through the plain version.
 16. the sharded table on one card: a 4-shard MeshBackend at 2^24 slots
     warmed to 10M keys answers phase 4's check() calls as a single table
     does; the psum GlobalEngine's syncs leave the single table's rows;
     a GUBER_MESH_WAYS=4 daemon serves pipelined, megaround and
     persistent traffic; every per-shard K1 launch replays bit-exact.
 17. the benchmark entry points: 17a cli/bench at 2^24 slots, 10M keys,
     262144 lanes a round and 4096 fed lanes (no skip, error or partial
     fed result; its first timed K1 dispatch replayed bit-exact through
     the plain ring_step on the CPU; staged batch 0's keys hold 1000 -
     hits, or what re-entry after an eviction left, or are missing from a
     full bucket; K1 timed at one 262144-lane round beside its byte
     bound); 17b cli/bench_e2e with --seconds 1, depth 2, the pipelined
     and persistent serve modes and every client mode (no error, platform
     cuda, K1 and K2 launched, each cluster's first K1 and K2 dispatches
     replayed bit-exact through the plain versions); 17c cli/microbench
     --seconds 1 --recompile-audit (six scenarios with ops, each kernel's
     library loaded, the first dispatches replayed); 17d graft.entry()'s
     step against its plain version and dryrun_multichip(4) on the card.

Phases 10-13 run with the JAX package's defaults: the hot-key and lease
planes on, the flight recorder off, so no owner advertises pressure; each
requires that nothing promoted and no mirror served.

Needs torch with CUDA, nvcc and a C++ compiler, and the daemon's wire
stack (grpcio, protobuf, aiohttp, prometheus_client, xxhash); imports no
JAX.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import traceback

import numpy as np

NUM_SLOTS = 1 << 24
WAYS = 8
BATCH = 32768
WARM_KEYS = 10_000_000
CHECK_BATCHES = 8
SEED = 20261016
T0_NS = 1_760_000_000_000 * 1_000_000  # frozen clock start (unix ns)


_START = time.perf_counter()


def log(*a) -> None:
    """Print a line with the seconds since the script started."""
    print(f"[{time.perf_counter() - _START:7.1f} s]", *a, flush=True)


def tables_equal(a, b) -> bool:
    """Bitwise equality of two SlotTables (float column compared as bits)."""
    import torch

    for x, y in zip(a, b):
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        if not torch.equal(x, y):
            return False
    return True


def max_abs_err(x, y) -> float:
    return float((x.double() - y.double()).abs().max()) if x.numel() else 0.0


def cuda_ms(fn, iters: int, flush) -> float:
    """Mean milliseconds per call of fn() on the current stream, each call
    timed by its own pair of CUDA events after flush() has evicted the L2
    cache (a check() finds its rows cold)."""
    import torch

    pairs = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


SXM_NAME = "NVIDIA H100 80GB HBM3"
SXM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def hbm_bytes_per_s(name: str) -> float:
    """Published memory rate of the card; only the H100 SXM's is known."""
    if name != SXM_NAME:
        raise ValueError(f"no published memory rate on file for {name!r}")
    return SXM_BYTES_PER_S


def useful_bytes(qs, resps, ways: int) -> int:
    """Bytes the decision step must move for these inputs and responses,
    each read or written once: nows; every lane's active word (8 B) and
    response (72 B); each active lane's other 11 request words (88 B) and
    the key/expire_at/touched words of its bucket (24 B a way); the rest of
    each found lane's row (60 B); and each written row (84 B)."""
    k, _, B = qs.shape
    active = int((qs[:, 10] != 0).sum())
    found = int((resps[:, 5] != 0).sum())
    written = int(((resps[:, 4] != 0) & (resps[:, 7] == 0)).sum())
    return (k * 8 + k * B * (8 + 72) + active * (88 + 24 * ways)
            + found * 60 + written * 84)


def profile_check(be, reqs):
    """One check() under torch.profiler (profile_device)."""
    return profile_device(lambda: be.check(reqs))


def profile_device(fn):
    """fn() under torch.profiler.  Returns its wall ms, the ms in which the
    device was busy (the union of the trace's device events), and the
    device ms of each event name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return wall_ms, busy_us / 1e3, by_name


def phase_build():
    """Both kernels' nvcc builds, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel
    from gubernator_tpu_torch.ops.kernels.build import build

    t0 = time.perf_counter()
    names = ("serve_kernel", "cms_kernel")
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build, names))
    serve_kernel.library()
    cms_kernel.library()
    for b in built:
        log(f"phase 1: built {b.path.name} in {b.seconds:.3f} s of nvcc")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())
    log(f"phase 1: both builds and loading took "
        f"{time.perf_counter() - t0:.3f} s")


def phase_random(dev) -> float:
    """Kernel vs plain on branch-covering random tables and rounds."""
    import torch

    from gubernator_tpu_torch.ops.kernels.serve_kernel import (
        INT32_MAX,
        new_claim_buffer,
        owners,
        persistent_serve_step,
    )
    from gubernator_tpu_torch.ops.ring import owner_partition, ring_step
    from gubernator_tpu_torch.ops.state import clone_table, table_from_host
    from gubernator_tpu_torch.testing import (
        KeySpace,
        owner_crowded_rounds,
        random_rounds,
        random_table,
    )

    now = T0_NS // 1_000_000
    err = 0.0
    G = owners(dev)
    log(f"phase 2: K1 bins lanes over G={G} owner blocks")
    # (num_slots, B, k, hot buckets, crowd one owner): small and crowded
    # (more owners than buckets), the main path's lane count, every lane
    # of each round in one owner's buckets, and more lanes than the card
    # has threads.
    cases = [(256, 64, 4, 4, False), (1 << 16, 4096, 4, 64, False),
             (1 << 20, BATCH, 3, 512, False), (1 << 20, BATCH, 2, 64, True),
             (1 << 20, 1 << 18, 2, 1024, False)]
    for n, (S, B, k, hot, crowd) in enumerate(cases):
        rng = np.random.default_rng(SEED + n)
        ks = KeySpace(rng, S, WAYS, hot_buckets=hot)
        host = random_table(rng, ks, now)
        if crowd:
            qs = torch.from_numpy(owner_crowded_rounds(
                rng, ks, host["key"], k, B, now, G)).to(dev)
            own, _ = owner_partition(qs, S // WAYS, G)
            if not bool((own[qs[:, 10] != 0] == 0).all()):
                raise AssertionError(f"case {n}: lanes outside owner 0")
        else:
            qs = torch.from_numpy(
                random_rounds(rng, ks, host["key"], k, B, now)).to(dev)
        nows = torch.tensor([now + 7 * b for b in range(k)],
                            dtype=torch.int64, device=dev)
        seq = torch.tensor(5, dtype=torch.int64, device=dev)
        kt = table_from_host(host, dev)
        pt = clone_table(kt)
        claim = new_claim_buffer(S, dev)
        kt, kr, kseq = persistent_serve_step(kt, qs, nows, seq, WAYS, claim)
        pt, pr, pseq = ring_step(pt, qs, nows, seq, WAYS)
        torch.cuda.synchronize()
        if not torch.equal(kr, pr):
            bad = (kr != pr).nonzero()[:5].tolist()
            raise AssertionError(f"case {n}: responses differ at {bad}")
        if not tables_equal(kt, pt):
            raise AssertionError(f"case {n}: tables differ")
        if int(kseq) != int(pseq) or int(kseq) != 5 + k:
            raise AssertionError(f"case {n}: seq {int(kseq)} vs {int(pseq)}")
        if not bool((claim == INT32_MAX).all()):
            raise AssertionError(f"case {n}: claim words not restored")
        act = qs[:, 10] != 0
        log(f"phase 2: case {n} S={S} B={B} k={k}"
            f"{' (one owner)' if crowd else ''}: bit-exact; lanes "
            f"active={int(act.sum())} found={int(pr[:, 5].sum())} "
            f"transient={int((act & (pr[:, 4] == 0)).sum())} "
            f"cached={int(pr[:, 7].sum())} over={int((pr[:, 0] == 1).sum())}")
        err = max(err, max_abs_err(kr, pr))
    return err


def phase_warm(be, dev, label="phase 3", keys=None) -> None:
    """Fill the table with `keys` (WARM_KEYS) synthetic fingerprints
    through the kernel."""
    import torch

    keys = WARM_KEYS if keys is None else keys

    rng = np.random.default_rng(SEED)
    now = be.clock.millisecond_now()
    seq = be.ring_seq_init()
    k = 16
    fed = 0
    t0 = time.perf_counter()
    n_launch = 0
    while True:
        if fed >= keys:
            occ = be.occupancy()
            if occ >= keys:
                break
        h = rng.integers(-(2**63), 2**63 - 1, size=(k, BATCH),
                         dtype=np.int64, endpoint=True)
        h[h == 0] = 1
        hd = torch.from_numpy(h).to(dev)
        qs = torch.zeros((k, 12, BATCH), dtype=torch.int64, device=dev)
        qs[:, 0] = hd
        qs[:, 1] = 1                       # hits
        qs[:, 2] = 100                     # limit
        qs[:, 3] = 3_600_000               # duration: live through the run
        qs[:, 4] = hd & 1                  # token / leaky
        qs[:, 5] = 100                     # burst
        qs[:, 10] = 1                      # active
        nows = torch.full((k,), now, dtype=torch.int64, device=dev)
        _, seq = be.persistent_serve_dispatch(qs, nows, seq)
        fed += k * BATCH
        n_launch += 1
        if fed >= keys:
            k = 1  # top up one round at a time
    torch.cuda.synchronize()
    log(f"{label}: fed {fed} fingerprints in {n_launch} launches "
        f"({time.perf_counter() - t0:.3f} s); occupancy {occ} of "
        f"{be.cfg.num_slots} slots; seq {int(seq)}")


def make_batches(rng):
    from gubernator_tpu_torch.core.interval import GREGORIAN_MINUTES
    from gubernator_tpu_torch.core.types import (
        Algorithm,
        Behavior,
        RateLimitReq,
    )

    n_keys = 150_000
    names = ["api", "login", "search", "upload"]
    batches = []
    for _ in range(CHECK_BATCHES):
        # Uniform keys repeat a few times per batch (and across batches);
        # ~0.2% of lanes go to 8 hot keys, ~8 repeats each.
        idx = rng.integers(0, n_keys, BATCH)
        hot = rng.random(BATCH) < 0.002
        idx[hot] = rng.integers(0, 8, int(hot.sum()))
        hits = rng.choice([0, 1, 1, 1, 1, 2, 5], BATCH)
        roll = rng.random(BATCH)
        reqs = []
        for i, u in enumerate(idx.tolist()):
            leaky = u % 3 == 0
            greg = roll[i] < 0.02
            reqs.append(RateLimitReq(
                name=names[u % 4],
                unique_key=f"tenant{u % 97}:user{u}",
                hits=int(hits[i]),
                limit=(10, 100, 1000)[u % 3 if not leaky else (u // 3) % 3],
                duration=GREGORIAN_MINUTES if greg else (1000, 60_000)[u % 2],
                algorithm=(Algorithm.LEAKY_BUCKET if leaky
                           else Algorithm.TOKEN_BUCKET),
                behavior=(Behavior.DURATION_IS_GREGORIAN if greg else
                          Behavior.RESET_REMAINING if roll[i] > 0.995
                          else Behavior.BATCHING),
            ))
        batches.append(reqs)
    return batches


def resp_tuple(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


def k1_path(dev, name: str, smi: str) -> dict:
    """Phases 2-5: K1 against its plain version, on the exact engine's main
    path, timed.  Returns K1's entry of the kernel line."""
    import torch

    from gubernator_tpu_torch.core.clock import Clock
    from gubernator_tpu_torch.core.config import DeviceConfig
    from gubernator_tpu_torch.ops.batch import pack_requests
    from gubernator_tpu_torch.ops.kernels import serve_kernel
    from gubernator_tpu_torch.ops.ring import ring_step
    from gubernator_tpu_torch.ops.state import clone_table
    from gubernator_tpu_torch.runtime.backend import (
        TorchBackend,
        packed_rounds_to_host,
        rounds_to_qs,
        unmarshal_responses,
    )

    err = phase_random(dev)

    clock = Clock()
    clock.freeze(T0_NS)
    be = TorchBackend(DeviceConfig(num_slots=NUM_SLOTS, ways=WAYS,
                                   batch_size=BATCH), clock=clock)
    phase_warm(be, dev)
    occ_warm = be.occupancy()

    # -- phase 4: the main path ------------------------------------------
    rng = np.random.default_rng(SEED + 100)
    batches = make_batches(rng)
    plain = clone_table(be.table)
    # Keep each main-path launch's request block and responses (references
    # only: nothing is copied inside check()).
    main = []
    launch = be._launch

    def recording_launch(qs, nows, seq):
        resps, seq = launch(qs, nows, seq)
        main.append((qs, resps))
        return resps, seq

    be._launch = recording_launch
    torch.cuda.synchronize()
    got, check_s = [], 0.0
    serve_kernel.launches = 0
    for j, reqs in enumerate(batches):
        clock.freeze(T0_NS + j * 250_000_000)
        t0 = time.perf_counter()
        got.append(be.check(reqs))
        check_s += time.perf_counter() - t0
    launches = serve_kernel.launches
    del be._launch
    if launches != CHECK_BATCHES:
        raise AssertionError(
            f"{launches} kernel launches for {CHECK_BATCHES} check() calls")
    n_reqs = sum(len(b) for b in batches)
    rounds_per_check = []
    seq = torch.zeros((), dtype=torch.int64, device=dev)
    pack_s = unpack_s = 0.0  # host-side parts of check(), on the replay
    for j, reqs in enumerate(batches):
        clock.freeze(T0_NS + j * 250_000_000)
        t0 = time.perf_counter()
        packed = pack_requests(reqs, BATCH, clock)
        pack_s += time.perf_counter() - t0
        qs = torch.from_numpy(main[j][0]).to(dev)
        rounds_per_check.append(qs.shape[0])
        nows = torch.full((qs.shape[0],), clock.millisecond_now(),
                          dtype=torch.int64, device=dev)
        plain, resps, seq = ring_step(plain, qs, nows, seq, WAYS)
        torch.cuda.synchronize()
        if not torch.equal(main[j][1], resps):
            raise AssertionError(f"check() batch {j}: kernel responses "
                                 "differ from the plain version's")
        t0 = time.perf_counter()
        want, _ = unmarshal_responses(len(reqs), packed.errors,
                                      packed.positions,
                                      packed_rounds_to_host(resps))
        unpack_s += time.perf_counter() - t0
        if [resp_tuple(r) for r in got[j]] != [resp_tuple(r) for r in want]:
            raise AssertionError(f"check() batch {j}: responses differ "
                                 "from the plain version")
    torch.cuda.synchronize()
    if not tables_equal(be.table, plain):
        raise AssertionError("table after check() differs from the plain "
                             "version's")
    if not bool((be.claim == serve_kernel.INT32_MAX).all()):
        raise AssertionError("claim words not restored after check()")
    over = sum(r.status == 1 for b in got for r in b)
    log(f"phase 4: {CHECK_BATCHES} check() x {BATCH} requests: "
        f"{launches} kernel launches, rounds per check {rounds_per_check}, "
        f"responses (all lanes) and table bit-exact vs plain, claim "
        f"words restored; "
        f"over_limit={over}; {n_reqs / check_s:.1f} check() decisions/s "
        f"(host clock, packing and unpacking included); occupancy "
        f"{occ_warm} -> {be.occupancy()}")

    # -- phase 5: timing ---------------------------------------------------
    now = clock.millisecond_now()
    claim = be.claim
    l2_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = l2_buf.zero_  # 256 MB written: nothing of the table stays in L2

    def timed(qs, iters_k, iters_p):
        """K1 and plain ms on replays of qs; bound from the first replay."""
        nows = torch.full((qs.shape[0],), now, dtype=torch.int64, device=dev)
        seq0 = torch.zeros((), dtype=torch.int64, device=dev)
        kern = lambda: serve_kernel.persistent_serve_step(  # noqa: E731
            be.table, qs, nows, seq0, WAYS, claim)
        _, kr, _ = kern()
        bound = useful_bytes(qs, kr, WAYS) / hbm_bytes_per_s(name) * 1e3
        for _ in range(2):
            kern()
        ms = cuda_ms(kern, iters_k, flush)
        pl = lambda: ring_step(plain, qs, nows, seq0, WAYS)  # noqa: E731
        pl()
        p_ms = cuda_ms(pl, iters_p, flush)
        return ms, p_ms, bound

    # The main path's bound counts batch 0's own launch: its request block
    # and the responses K1 gave on the main path.
    first_qs = torch.from_numpy(main[0][0]).to(dev)
    main_bound = (useful_bytes(first_qs, main[0][1], WAYS)
                  / hbm_bytes_per_s(name) * 1e3)
    main_ms, main_plain, _ = timed(first_qs, 20, 3)
    log(f"phase 5 ({smi}): K1 at the main path's shape qs"
        f"{list(first_qs.shape)}: {main_ms:.4f} ms/launch, plain "
        f"{main_plain:.4f} ms, bound {main_bound:.4f} ms (batch 0's own "
        f"launch: {int((first_qs[:, 10] != 0).sum())} active lanes)")
    per = 1e3 / CHECK_BATCHES
    log(f"phase 5: check() of {BATCH} requests, mean ms: total "
        f"{check_s * per:.3f}; pack_requests {pack_s * per:.3f}; fetch + "
        f"unmarshal {unpack_s * per:.3f}")
    clock.freeze(T0_NS + CHECK_BATCHES * 250_000_000)
    wall_ms, busy_ms, by_name = profile_check(be, batches[0])
    if busy_ms > 0:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log(f"phase 5: torch.profiler, one check(): {wall_ms:.3f} ms wall, "
            f"device busy {busy_ms:.4f} ms ({busy_ms / wall_ms:.4%}); "
            + "; ".join(f"{n} {t:.4f} ms" for n, t in top))
    else:
        log("phase 5: torch.profiler recorded no device time: device busy "
            "share not measured")
    first_rounds = [first_qs[0]] + [
        torch.from_numpy(rounds_to_qs(
            pack_requests(b, BATCH, clock).rounds[:1], be._tiers)[0]
        ).to(dev) for b in batches[1:8]]
    for k in (1, 8):
        qs = torch.stack(first_rounds[:k]).contiguous()
        ms, p_ms, bound = timed(qs, 20, 3)
        log(f"phase 5: K1 k={k} B={qs.shape[2]}: {ms:.4f} ms/launch "
            f"({ms / k:.4f} ms/round), plain {p_ms:.4f} ms, bound "
            f"{bound:.4f} ms")
    return {
        "name": "serve_kernel",
        "route": "cuda",
        "source": "gubernator_tpu_torch/csrc/serve_kernel.cu",
        "replaces": "gubernator_tpu/ops/pallas/serve_kernel.py:57",
        "launches": launches,
        "max_abs_err": err,
        "ms": main_ms,
        "plain_ms": main_plain,
        "bound_ms": main_bound,
        "bound_by": "bytes",
        "library_ms": None,
    }


SKETCH_DEPTH = 4
SKETCH_WIDTH = 1 << 20
SKETCH_WINDOW_MS = 60_000
SKETCH_BATCH = 1024          # lanes per chunk (SketchTierConfig.batch_size)
SKETCH_KEYS = 100_000_000    # key space of the deployment
SKETCH_WARM_HITS = 48_000_000
SKETCH_WARM_SHAPE = (32, 32768)  # chunks x lanes per warm-up launch
SKETCH_REQS = 32768          # requests per check()
SKETCH_HOT_KEYS = 64
# Phase 6's (W, k, B): crowded to full width, one chunk and a full merge,
# one lane more than a block walks, and more lanes than the grid has
# threads.
SKETCH_RANDOM_CASES = [(1 << 10, 1, 1024), (1 << 10, 32, 1024),
                       (1 << 10, 4, 1025), (1 << 16, 4, 4096),
                       (1 << 20, 1, 1024), (1 << 20, 32, 1024),
                       (1 << 20, 1, 1 << 19)]
# Where each check() of phase 8 lands, in ms after the warmed window's
# start: 13 calls in the warmed window, then one behind (the window rolls:
# cur becomes prev), sliding inside that window, and far behind (both
# tables clear).
SKETCH_CALL_MS = [2_000 + 4_000 * j for j in range(13)] + [
    61_000, 100_000, 300_000]


def sketch_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def sketch_err(a, b) -> float:
    return max(max_abs_err(x, y) for x, y in zip(a, b))


def fingerprints(ids):
    """Well-mixed nonzero int64 fingerprints of int64 key ids (the
    splitmix64 finalizer, wrapping, with logical shifts)."""
    def srl(x, n):
        return (x >> n) & ((1 << (64 - n)) - 1)

    def i64(u):
        return u - (1 << 64) if u >= 1 << 63 else u

    z = (ids + 1) * i64(0x9E3779B97F4A7C15)
    z = (z ^ srl(z, 30)) * i64(0xBF58476D1CE4E5B9)
    z = (z ^ srl(z, 27)) * i64(0x94D049BB133111EB)
    z = z ^ srl(z, 31)
    return z.masked_fill(z == 0, 1)


def phase_sketch_random(dev) -> float:
    """K2 vs plain on seeded branch-covering sketches and merges, in every
    window case of the rotation."""
    import torch

    from gubernator_tpu_torch.ops.kernels.cms_kernel import (
        cluster_blocks,
        cms_multi_step,
    )
    from gubernator_tpu_torch.ops.sketch import (
        SketchState,
        clone_sketch,
        multi_step,
    )
    from gubernator_tpu_torch.testing import (
        I32_MAX,
        WINDOW_CASES,
        cross_chunk_lanes,
        random_sketch,
        random_sketch_lanes,
        window_now,
    )

    ws0 = (T0_NS // 10**6) // SKETCH_WINDOW_MS * SKETCH_WINDOW_MS
    err = 0.0
    log(f"phase 6: K2 walks chunks of <= 1024 lanes with a cluster of "
        f"{cluster_blocks(dev)} blocks")
    for n, (W, k, B) in enumerate(SKETCH_RANDOM_CASES):
        rng = np.random.default_rng(SEED + 200 + n)
        big = rng.integers(-(2**63), 2**63 - 1, 16, dtype=np.int64)
        host = random_sketch(rng, SKETCH_DEPTH, W, ws0, SKETCH_WINDOW_MS, big)
        lanes = [torch.from_numpy(a).to(dev)
                 for a in random_sketch_lanes(rng, k, B, big)]
        base = SketchState(
            torch.from_numpy(host["cur"]).to(dev),
            torch.from_numpy(host["prev"]).to(dev),
            torch.tensor(ws0, dtype=torch.int64, device=dev),
            torch.tensor(SKETCH_WINDOW_MS, dtype=torch.int64, device=dev))
        seen = []
        for case in WINDOW_CASES:
            now = window_now(case, ws0, SKETCH_WINDOW_MS)
            ks, kp = cms_multi_step(clone_sketch(base), *lanes, now)
            ps, pp = multi_step(base, *lanes, now)
            torch.cuda.synchronize()
            if not torch.equal(kp, pp):
                bad = (kp != pp).nonzero()[:5].tolist()
                raise AssertionError(f"K2 case {n} {case}: packed differs "
                                     f"at {bad}")
            if not sketch_equal(ks, ps):
                raise AssertionError(f"K2 case {n} {case}: sketch differs")
            case_err = max(max_abs_err(kp, pp), sketch_err(ks, ps))
            err = max(err, case_err)
            seen.append(f"{case} over={int(kp[:, 0].sum())} "
                        f"sat={int((kp[:, 1] == I32_MAX).sum())} "
                        f"max_abs_err={case_err}")
        act = int((lanes[0] != 0).sum())
        log(f"phase 6: K2 case {n} W={W} k={k} B={B} ({act} active lanes): "
            f"bit-exact in every window case; " + "; ".join(seen))

    # One key across 32 chunks of an empty 2^4 sketch: chunk c must read
    # the adds of chunks 0..c-1, so the key estimates c there and goes over
    # from chunk 15 on.  Its cells repeat in every chunk, which is what
    # catches a stale read of cur.
    rng = np.random.default_rng(SEED + 299)
    kh, hits, lim, lane = cross_chunk_lanes(rng, 32, SKETCH_BATCH, 15)
    lanes = [torch.from_numpy(a).to(dev) for a in (kh, hits, lim)]
    empty = torch.zeros((SKETCH_DEPTH, 16), dtype=torch.int32, device=dev)
    base = SketchState(empty, empty.clone(),
                       torch.tensor(ws0, dtype=torch.int64, device=dev),
                       torch.tensor(SKETCH_WINDOW_MS, dtype=torch.int64,
                                    device=dev))
    ks, kp = cms_multi_step(clone_sketch(base), *lanes, ws0)
    ps, pp = multi_step(base, *lanes, ws0)
    torch.cuda.synchronize()
    if not torch.equal(kp, pp) or not sketch_equal(ks, ps):
        raise AssertionError("K2 cross-chunk case differs from the plain "
                             "version")
    rows = torch.arange(32, device=dev)
    est = kp[rows, 1, torch.from_numpy(lane).to(dev)].tolist()
    if est != list(range(32)):
        raise AssertionError(f"K2 cross-chunk estimates {est}")
    first = int(kp[:, 0].any(dim=1).nonzero()[0])
    err = max(err, max_abs_err(kp, pp), sketch_err(ks, ps))
    log(f"phase 6: K2 one key across 32 chunks of B={SKETCH_BATCH}, W=16: "
        f"bit-exact; estimates 0..31 by chunk, first over in chunk {first}")
    if first != 15:
        raise AssertionError(f"first over chunk {first}, expected 15")
    return err


def sketch_requests(rng, hot_ids):
    """One check()'s requests, as bench_e2e.py's cms_sketch_100m_space
    sets them up: keys uniform in a 100M space, hits 1, limit 1M, 60 s;
    ~1% of lanes go to the hot keys, whose limit is 100."""
    from gubernator_tpu_torch.core.types import RateLimitReq

    ids = rng.integers(0, SKETCH_KEYS, SKETCH_REQS)
    hot = rng.random(SKETCH_REQS) < 0.01
    ids[hot] = rng.choice(hot_ids, int(hot.sum()))
    return [RateLimitReq(name="cms", unique_key=f"s{k}", hits=1,
                         limit=100 if h else 1_000_000, duration=60_000)
            for k, h in zip(ids.tolist(), hot.tolist())]


def sketch_useful_bytes(depth: int, width: int, kh, rolled: bool) -> int:
    """Bytes a merge must move for these inputs, each read or written
    once: 24 B a lane (fingerprint, hits, limit, packed out), 12 B a
    distinct touched (row, column) cell (read cur and prev, write cur), and
    on a merge that rolls the window 12 B a cell of the tables (read cur,
    write prev and cur)."""
    import torch

    from gubernator_tpu_torch.ops.sketch import row_columns

    k, B = kh.shape
    act = kh.reshape(-1)[kh.reshape(-1) != 0]
    rows = torch.arange(depth, device=kh.device)[:, None] * width
    cells = (row_columns(act, depth, width).to(torch.int64) + rows).unique()
    return (24 * k * B + 12 * int(cells.numel())
            + (12 * depth * width if rolled else 0))


def k2_path(dev, name: str, smi: str) -> dict:
    """Phases 6-9: K2 against its plain version, on the sketch tier's main
    path at the 100M-key deployment, timed.  Returns K2's entry of the
    kernel line."""
    import torch

    from gubernator_tpu_torch.core.clock import Clock
    from gubernator_tpu_torch.core.config import SketchTierConfig
    from gubernator_tpu_torch.core.hashing import bulk_key_hash64
    from gubernator_tpu_torch.core.types import RateLimitResp, Status
    from gubernator_tpu_torch.ops.kernels import cms_kernel
    from gubernator_tpu_torch.ops.sketch import (
        SketchState,
        clone_sketch,
        multi_step,
    )
    from gubernator_tpu_torch.runtime.sketch_backend import SketchBackend

    err = phase_sketch_random(dev)

    # -- phase 7: the tier at the 100M-key deployment, warmed -------------
    cfg = SketchTierConfig(names=["cms"], depth=SKETCH_DEPTH,
                           width=SKETCH_WIDTH, window_ms=SKETCH_WINDOW_MS,
                           batch_size=SKETCH_BATCH)
    t0_ms = T0_NS // 10**6
    ws = t0_ms - t0_ms % SKETCH_WINDOW_MS
    clock = Clock()
    clock.freeze((ws + 1_000) * 10**6)
    be = SketchBackend(cfg, clock=clock, device=dev)
    t0 = time.perf_counter()
    be.warmup()
    log(f"phase 7: SketchBackend on {be.device}: warmup() (K2 library and "
        f"one launch) took {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    kw, bw = SKETCH_WARM_SHAPE
    hits = torch.ones((kw, bw), dtype=torch.int32, device=dev)
    lim = torch.full((kw, bw), 1_000_000, dtype=torch.int32, device=dev)
    fed, t0 = 0, time.perf_counter()
    while fed < SKETCH_WARM_HITS:
        ids = torch.randint(0, SKETCH_KEYS, (kw, bw), generator=gen,
                            device=dev)
        now = clock.millisecond_now()
        be._advance_window(now)  # the host mirror, as check() keeps it
        be.state, _ = cms_kernel.cms_multi_step(
            be.state, fingerprints(ids), hits, lim, now)
        fed += kw * bw
    torch.cuda.synchronize()
    cells = be.state.cur.to(torch.float64)
    log(f"phase 7: warmed the window with {fed} hits over a "
        f"{SKETCH_KEYS}-key space in {time.perf_counter() - t0:.3f} s: "
        f"mean {float(cells.mean()):.3f} counts a cell, max "
        f"{int(be.state.cur.max())}; window_start {int(be.state.window_start)}"
        f" (host mirror {be._win_start})")
    if int(be.state.window_start) != be._win_start:
        raise AssertionError("host window mirror differs from the device's")

    # -- phase 8: the main path --------------------------------------------
    rng = np.random.default_rng(SEED + 300)
    hot_ids = rng.integers(0, SKETCH_KEYS, SKETCH_HOT_KEYS)
    batches = [sketch_requests(rng, hot_ids) for _ in SKETCH_CALL_MS]
    start_state = clone_sketch(be.state)
    plain = SketchBackend(cfg, clock=clock, device=dev)
    plain.state = clone_sketch(be.state)
    plain._win_start = be._win_start

    # Keep each main-path launch's inputs and packed outputs (references
    # only: nothing is copied inside check()).
    main = []
    dispatch = be._dispatch

    def recording_dispatch(kh, hc, lc, now):
        packed = dispatch(kh, hc, lc, now)
        main.append((kh, hc, lc, now, packed))
        return packed

    plain_packed = []

    def plain_dispatch(kh, hc, lc, now):
        def d(a):
            return torch.from_numpy(a).to(dev)

        plain.state, packed = multi_step(plain.state, d(kh), d(hc), d(lc),
                                         now)
        plain_packed.append(packed)
        return packed

    be._dispatch = recording_dispatch
    plain._dispatch = plain_dispatch
    torch.cuda.synchronize()
    got, check_s = [], 0.0
    cms_kernel.launches = 0
    for off, reqs in zip(SKETCH_CALL_MS, batches):
        clock.freeze((ws + off) * 10**6)
        t0 = time.perf_counter()
        got.append(be.check(reqs))
        check_s += time.perf_counter() - t0
    launches = cms_kernel.launches
    del be._dispatch
    if launches != len(batches):
        raise AssertionError(
            f"{launches} K2 launches for {len(batches)} check() calls")
    for j, (off, reqs) in enumerate(zip(SKETCH_CALL_MS, batches)):
        clock.freeze((ws + off) * 10**6)
        want = plain.check(reqs)
        packed, pp = main[j][4], plain_packed[j]
        if not torch.equal(packed, pp):
            bad = (packed != pp).nonzero()[:5].tolist()
            raise AssertionError(f"sketch check() {j}: K2's packed output "
                                 f"differs from the plain version's at {bad}")
        err = max(err, max_abs_err(packed, pp))
        if [resp_tuple(r) + (r.metadata,) for r in got[j]] != \
                [resp_tuple(r) + (r.metadata,) for r in want]:
            raise AssertionError(f"sketch check() {j}: responses differ "
                                 "from the plain version's")
    if cms_kernel.launches != launches:
        raise AssertionError("the plain replay launched K2")
    torch.cuda.synchronize()
    if not sketch_equal(be.state, plain.state):
        raise AssertionError("sketch after check() differs from the plain "
                             "version's")
    over = sum(int(r.status == Status.OVER_LIMIT) for b in got for r in b)
    hot_over = sum(int(r.status == Status.OVER_LIMIT and r.limit == 100)
                   for b in got for r in b)
    per_call = [sum(int(r.status) for r in b) for b in got]
    n_reqs = sum(len(b) for b in batches)
    log(f"phase 8: {len(batches)} sketch check() x {SKETCH_REQS} requests "
        f"(k={main[0][0].shape[0]} chunks of {SKETCH_BATCH}): {launches} K2 "
        f"launches; packed outputs (all lanes), responses and final sketch "
        f"bit-exact vs plain; over_limit={over} ({hot_over} on hot keys), "
        f"per call {per_call}; {n_reqs / check_s:.1f} check() decisions/s "
        f"(host clock, hashing and responses included)")
    if over == 0:
        raise AssertionError("no OVER_LIMIT answer on the sketch main path")
    if not isinstance(got[0][0], RateLimitResp) or \
            got[0][0].metadata != {"tier": "sketch"}:
        raise AssertionError("sketch responses lack metadata tier=sketch")

    # -- phase 9: timing -----------------------------------------------------
    l2_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = l2_buf.zero_
    kh0, hc0, lc0, now0, _ = main[0]
    lanes0 = [torch.from_numpy(a).to(dev) for a in (kh0, hc0, lc0)]
    bound0 = (sketch_useful_bytes(SKETCH_DEPTH, SKETCH_WIDTH, lanes0[0],
                                  False) / hbm_bytes_per_s(name) * 1e3)

    def timed(lanes, now, iters_k, iters_p, roll_from=None):
        """K2 and plain ms on repeats of one merge, each on a copy of the
        warmed sketch; `roll_from` resets window_start before each run (in
        the flush, outside the timed span) so every run rolls."""
        ks, ps = clone_sketch(start_state), clone_sketch(start_state)

        def prep():
            flush()
            if roll_from is not None:
                ks.window_start.fill_(roll_from)

        def kern():
            cms_kernel.cms_multi_step(ks, *lanes, now)

        def pl():
            if roll_from is not None:
                pl_state = SketchState(ps.cur, ps.prev,
                                       torch.tensor(roll_from, device=dev),
                                       ps.window_ms)
            else:
                pl_state = ps
            multi_step(pl_state, *lanes, now)

        kern()
        ms = cuda_ms(kern, iters_k, prep)
        pl()
        p_ms = cuda_ms(pl, iters_p, prep)
        return ms, p_ms

    main_ms, main_plain = timed(lanes0, now0, 20, 3)
    log(f"phase 9 ({smi}): K2 at the main path's shape (k={kh0.shape[0]}, "
        f"B={kh0.shape[1]}, D={SKETCH_DEPTH}, W={SKETCH_WIDTH}): "
        f"{main_ms:.4f} ms/launch, plain {main_plain:.4f} ms, bound "
        f"{bound0:.6f} ms (call 0's own merge: "
        f"{int((lanes0[0] != 0).sum())} active lanes)")
    one = [t[:1].contiguous() for t in lanes0]
    b1 = (sketch_useful_bytes(SKETCH_DEPTH, SKETCH_WIDTH, one[0], False)
          / hbm_bytes_per_s(name) * 1e3)
    ms1, p1 = timed(one, now0, 20, 3)
    log(f"phase 9: K2 k=1 B={SKETCH_BATCH}: {ms1:.4f} ms/launch, plain "
        f"{p1:.4f} ms, bound {b1:.6f} ms")
    roll_now = ws + SKETCH_WINDOW_MS + 1_000
    br = (sketch_useful_bytes(SKETCH_DEPTH, SKETCH_WIDTH, lanes0[0], True)
          / hbm_bytes_per_s(name) * 1e3)
    msr, pr = timed(lanes0, roll_now, 20, 3, roll_from=ws)
    log(f"phase 9: K2 k={kh0.shape[0]} on a merge that rolls the window "
        f"(one behind): {msr:.4f} ms/launch, plain {pr:.4f} ms, bound "
        f"{br:.6f} ms")
    # The warm-up's shape: chunks wider than a block take the grid walk.
    wgen = torch.Generator(device=dev)
    wgen.manual_seed(SEED + 1)
    wk, wb = SKETCH_WARM_SHAPE
    wlanes = [fingerprints(torch.randint(0, SKETCH_KEYS, (wk, wb),
                                         generator=wgen, device=dev)),
              torch.ones((wk, wb), dtype=torch.int32, device=dev),
              torch.full((wk, wb), 1_000_000, dtype=torch.int32, device=dev)]
    bw = (sketch_useful_bytes(SKETCH_DEPTH, SKETCH_WIDTH, wlanes[0], False)
          / hbm_bytes_per_s(name) * 1e3)
    msw, pw = timed(wlanes, now0, 10, 1)
    log(f"phase 9: K2 at the warm-up's shape (k={wk}, B={wb}, grid walk): "
        f"{msw:.4f} ms/launch, plain {pw:.4f} ms, bound {bw:.6f} ms")

    # check()'s host time, by stage, on replays of the main path's calls.
    stage = {"hash": 0.0, "pad+copy+launch": 0.0, "launch": 0.0,
             "fetch": 0.0, "responses": 0.0}
    dispatch = be._dispatch

    def timed_dispatch(kh, hc, lc, now):
        t = time.perf_counter()
        packed = dispatch(kh, hc, lc, now)
        stage["launch"] += time.perf_counter() - t
        return packed

    be._dispatch = timed_dispatch
    for off, reqs in zip(SKETCH_CALL_MS, batches):
        clock.freeze((ws + off) * 10**6)
        t0 = time.perf_counter()
        kh = bulk_key_hash64([r.hash_key() for r in reqs])
        hits_a = np.array([r.hits for r in reqs], dtype=np.int64)
        lim_a = np.array([r.limit for r in reqs], dtype=np.int64)
        t1 = time.perf_counter()
        fetch = be.check_cols_begin(kh, hits_a, lim_a)
        t2 = time.perf_counter()
        status, remaining, reset = fetch()
        t3 = time.perf_counter()
        _ = [RateLimitResp(
            status=Status.OVER_LIMIT if status[j] else Status.UNDER_LIMIT,
            limit=int(lim_a[j]), remaining=int(remaining[j]),
            reset_time=int(reset[j]), metadata={"tier": "sketch"})
            for j in range(len(reqs))]
        t4 = time.perf_counter()
        stage["hash"] += t1 - t0
        stage["pad+copy+launch"] += t2 - t1
        stage["fetch"] += t3 - t2
        stage["responses"] += t4 - t3
    del be._dispatch
    per = 1e3 / len(batches)
    log(f"phase 9: sketch check() of {SKETCH_REQS} requests, mean ms: total "
        f"{check_s * per:.3f} (main path); replayed by stage: hash_key + "
        f"XXH64 + arrays {stage['hash'] * per:.3f}; pad, clamp, H2D copies "
        f"and launch {stage['pad+copy+launch'] * per:.3f} (of which the "
        f"K2 wrapper call {stage['launch'] * per:.3f}); fetch (event wait, "
        f"remaining) {stage['fetch'] * per:.3f}; RateLimitResp objects "
        f"{stage['responses'] * per:.3f}")
    clock.freeze((ws + SKETCH_CALL_MS[-1] + 500) * 10**6)
    wall_ms, busy_ms, by_name = profile_check(be, batches[0])
    if busy_ms > 0:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log(f"phase 9: torch.profiler, one sketch check(): {wall_ms:.3f} ms "
            f"wall, device busy {busy_ms:.4f} ms ({busy_ms / wall_ms:.4%}); "
            + "; ".join(f"{n} {t:.4f} ms" for n, t in top))
    else:
        log("phase 9: torch.profiler recorded no device time: device busy "
            "share not measured")
    return {
        "name": "cms_kernel",
        "route": "cuda",
        "source": "gubernator_tpu_torch/csrc/cms_kernel.cu",
        "replaces": "gubernator_tpu/ops/pallas/cms_kernel.py:44",
        "launches": launches,
        "max_abs_err": err,
        "ms": main_ms,
        "plain_ms": main_plain,
        "bound_ms": bound0,
        "bound_by": "bytes",
        "library_ms": None,
    }

# -- phases 10-11: the daemon -------------------------------------------------
DAEMON_SLOTS = 1 << 24       # phase 10: the library path's geometry
SMALL_SLOTS = 1 << 20        # phase 11: the other modes and the cluster
DAEMON_CLIENTS = 64          # concurrent gRPC clients
DAEMON_RPCS = 6              # sequential RPCs per client in a phase-10 mode
SMALL_CLIENTS = 16
SMALL_RPCS = 3
RPC_REQS = 1000              # MAX_BATCH_SIZE requests per GetRateLimits
PROFILE_RPCS = 2             # per client, under torch.profiler (~1 s)
CLUSTER_RPCS = 8             # sequential RPCs through node 0 in phase 11
V1_RPC = "/pb.gubernator.V1/GetRateLimits"


def rpc_requests(rng, n_rpc: int, first_key: int = 0, pool=None):
    """`n_rpc` GetRateLimits payloads of RPC_REQS requests: PERF.md §4's
    exact-tier mix (token:leaky 2:1, 2% Gregorian, 0.5% RESET_REMAINING,
    0.2% of lanes on 8 hot keys) with 1/8 of the requests on the sketch
    tier's name ("cms", keys uniform over its 100M-key space).  With
    `pool`, the exact-tier key ids are drawn from it."""
    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.core.interval import GREGORIAN_MINUTES
    from gubernator_tpu_torch.core.types import (
        Algorithm,
        Behavior,
        RateLimitReq,
    )

    names = ["api", "login", "search", "upload"]
    out = []
    for _ in range(n_rpc):
        idx = rng.integers(0, 150_000, RPC_REQS) + first_key
        hot = rng.random(RPC_REQS) < 0.002
        idx[hot] = rng.integers(0, 8, int(hot.sum()))
        if pool is not None:
            idx = pool[rng.integers(0, len(pool), RPC_REQS)]
            idx[hot] = pool[rng.integers(0, 8, int(hot.sum()))]
        sk = rng.random(RPC_REQS) < 1 / 8
        sk_ids = rng.integers(0, SKETCH_KEYS, RPC_REQS)
        hits = rng.choice([0, 1, 1, 1, 1, 2, 5], RPC_REQS)
        roll = rng.random(RPC_REQS)
        reqs = []
        for i, u in enumerate(idx.tolist()):
            if sk[i]:
                reqs.append(RateLimitReq(
                    name="cms", unique_key=f"s{int(sk_ids[i])}", hits=1,
                    limit=1_000_000, duration=SKETCH_WINDOW_MS))
                continue
            leaky = u % 3 == 0
            greg = roll[i] < 0.02
            reqs.append(RateLimitReq(
                name=names[u % 4], unique_key=f"tenant{u % 97}:user{u}",
                hits=int(hits[i]),
                limit=(10, 100, 1000)[u % 3 if not leaky else (u // 3) % 3],
                duration=GREGORIAN_MINUTES if greg else (1000, 60_000)[u % 2],
                algorithm=(Algorithm.LEAKY_BUCKET if leaky
                           else Algorithm.TOKEN_BUCKET),
                behavior=(Behavior.DURATION_IS_GREGORIAN if greg else
                          Behavior.RESET_REMAINING if roll[i] > 0.995
                          else Behavior.BATCHING)))
        out.append(native.encode_reqs(reqs))
    return out


class DispatchRecorder:
    """Keeps every K1 and K2 dispatch a daemon makes, in table order (both
    happen under their backend's lock): the request block, clock and
    sequence word in, and the kernel's output.  Nothing is copied: each
    of these is a fresh array or tensor per dispatch."""

    def __init__(self, be, sb, state=None):
        self.be, self.sb = be, sb
        self.k1, self.k2 = [], []
        # The table's mutations in order: ("k1", j) for the j-th K1
        # dispatch, ("op", name, args) for a state-plane op the
        # StateOpRecorder saw on this table (a Store seed, a repair).
        self.seq = []
        self.state = state
        if state is not None:
            state.sinks[be.table.key.data_ptr()] = self
        self._launch, self._dispatch = be._launch, sb._dispatch

        def launch(qs, nows, seq):
            resps, seq_out = self._launch(qs, nows, seq)
            self.seq.append(("k1", len(self.k1)))
            self.k1.append((qs, nows, seq, resps))
            return resps, seq_out

        def dispatch(kh, hc, lc, now):
            packed = self._dispatch(kh, hc, lc, now)
            self.k2.append((kh, hc, lc, now, packed))
            return packed

        be._launch, sb._dispatch = launch, dispatch

    def close(self):
        del self.be._launch, self.sb._dispatch
        if self.state is not None:
            self.state.sinks.pop(self.be.table.key.data_ptr(), None)

    def replay(self, dev, table, sketch) -> float:
        """Every recorded dispatch again through the plain versions, in
        order, on copies of the starting table and sketch; requires the
        outputs, the final table and sketch and the claim words equal."""
        import torch

        from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel
        from gubernator_tpu_torch.ops.ring import ring_step
        from gubernator_tpu_torch.ops.sketch import multi_step

        def d(a):
            return torch.as_tensor(a).to(dev)

        k1_before, k2_before = serve_kernel.launches, cms_kernel.launches
        err = 0.0
        for ev in self.seq:
            if ev[0] == "op":  # the same torch op, in table order
                self.state.orig[ev[1]](table, *ev[2])
                continue
            j = ev[1]
            qs, nows, seq, resps = self.k1[j]
            s = seq if isinstance(seq, torch.Tensor) else torch.tensor(
                seq, dtype=torch.int64, device=dev)
            table, pr, _ = ring_step(table, d(qs), d(nows), s, WAYS)
            if not torch.equal(pr, resps):
                raise AssertionError(f"K1 dispatch {j}: responses differ "
                                     "from the plain version's")
            err = max(err, max_abs_err(pr, resps))
        for j, (kh, hc, lc, now, packed) in enumerate(self.k2):
            sketch, pp = multi_step(sketch, d(kh), d(hc), d(lc), now)
            if not torch.equal(pp, packed):
                raise AssertionError(f"K2 dispatch {j}: outputs differ "
                                     "from the plain version's")
            err = max(err, max_abs_err(pp, packed))
        torch.cuda.synchronize()
        if (serve_kernel.launches, cms_kernel.launches) != (k1_before,
                                                            k2_before):
            raise AssertionError("the plain replay launched a kernel")
        if not tables_equal(self.be.table, table):
            raise AssertionError("daemon table differs from the plain "
                                 "replay's")
        if not sketch_equal(self.sb.state, sketch):
            raise AssertionError("daemon sketch differs from the plain "
                                 "replay's")
        claim = self.be.claim  # None only where no kernel runs (the CPU)
        if claim is not None and not bool(
                (claim == serve_kernel.INT32_MAX).all()):
            raise AssertionError("claim words not restored")
        return err


async def drive_rpcs(addr, per_client):
    """Each client sends its payloads one after another; all clients at
    once.  Returns (wall seconds, per-RPC latencies in seconds, the
    response count of every RPC)."""
    import asyncio

    import grpc

    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    lat, counts = [], []

    async def client(payloads):
        async with grpc.aio.insecure_channel(addr) as ch:
            rpc = ch.unary_unary(V1_RPC)
            for p in payloads:
                t = time.perf_counter()
                raw = await rpc(p, timeout=300)
                lat.append(time.perf_counter() - t)
                counts.append(len(pb.GetRateLimitsResp.FromString(
                    raw).responses))

    t0 = time.perf_counter()
    await asyncio.gather(*(client(ps) for ps in per_client))
    return time.perf_counter() - t0, lat, counts


async def control_key(addr):
    """One key driven past its limit with sequential single-request RPCs:
    the wire must give remaining 4, 3, 2, 1, 0 then OVER_LIMIT twice."""
    import grpc

    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    req = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
        name="control", unique_key="driven", hits=1, limit=5,
        duration=3_600_000)]).SerializeToString()
    got = []
    async with grpc.aio.insecure_channel(addr) as ch:
        for _ in range(7):
            r = pb.GetRateLimitsResp.FromString(
                await ch.unary_unary(V1_RPC)(req, timeout=60)).responses[0]
            got.append((r.status, r.limit, r.remaining, r.error))
    want = [(0, 5, n, "") for n in (4, 3, 2, 1, 0)] + [(1, 5, 0, "")] * 2
    if got != want:
        raise AssertionError(f"control key on the wire: {got}")


def start_daemons(dev, n, slots, mode, shards=1, **conf):
    """n daemons of the port (one in-process cluster) on `dev`, each table
    split into `shards` shards; `conf` adds DaemonConfig fields (a Store, a
    Loader)."""
    from gubernator_tpu_torch.core.config import (
        DaemonConfig,
        DeviceConfig,
        SketchTierConfig,
    )
    from gubernator_tpu_torch.testing.cluster import Cluster

    sketch = SketchTierConfig(names=["cms"], depth=SKETCH_DEPTH,
                              width=SKETCH_WIDTH, window_ms=SKETCH_WINDOW_MS,
                              batch_size=SKETCH_BATCH)
    return Cluster.start_with(
        [""] * n,
        device=DeviceConfig(num_slots=slots, ways=WAYS, batch_size=BATCH,
                            num_shards=shards, platform=dev.type),
        conf_template=DaemonConfig(serve_mode=mode, sketch=sketch, **conf))


def require_planes_inactive(label, daemons) -> None:
    """The hot-key and lease planes are armed, as by default, and with the
    flight recorder off no owner advertised pressure: nothing promoted and
    no mirror served."""
    for d in daemons:
        s = d.service
        if s.hotkeys is None or s.leases is None:
            raise AssertionError(f"{label}: the hot-key or lease plane is "
                                 "off under the defaults")
        if s.hotkeys.promotions or s.mirror_served:
            raise AssertionError(
                f"{label}: {s.hotkeys.promotions} promotions, "
                f"{s.mirror_served} mirror serves without pressure")
    log(f"{label}: hot-key and lease planes on in {len(daemons)} daemon(s); "
        "promotions 0, mirror_served 0 (flight recorder off)")


def percentiles_ms(lat):
    a = np.sort(np.asarray(lat)) * 1e3
    return [float(np.percentile(a, q)) for q in (50, 99, 99.9)]


def serve_mode_run(dev, mode, slots, clients, rpcs, rng, smi, warm=False,
                   profile=False, after=None):
    """One serve mode on one daemon: traffic over gRPC with every K1/K2
    dispatch recorded, the control key, then the plain replay; then
    `after(cluster, daemon)` on the served daemon when given.  Returns
    (max_abs_err, K1 launches, K2 launches)."""
    import asyncio

    import torch

    from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel
    from gubernator_tpu_torch.ops.sketch import clone_sketch
    from gubernator_tpu_torch.ops.state import clone_table

    c = start_daemons(dev, 1, slots, mode)
    try:
        d = c.daemons[0]
        be, sb, fp = d.service.backend, d.service.sketch_backend, d.fastpath
        if be.device.type != dev.type or fp.effective_serve_mode != mode:
            raise AssertionError(f"{mode}: daemon on {be.device}, serving "
                                 f"{fp.effective_serve_mode}")
        if warm:
            phase_warm(be, dev, f"phase 10 ({mode})")
        torch.cuda.synchronize()
        table, sketch = clone_table(be.table), clone_sketch(sb.state)
        per_client = [rpc_requests(rng, rpcs, first_key=1 + 10_000 * j)
                      for j in range(clients)]
        rec = DispatchRecorder(be, sb)
        spent = {}
        time_calls(d.service, "note_traffic", spent)
        serve_kernel.launches = cms_kernel.launches = 0
        # The clients share the daemon's event loop: grpc.aio serves one
        # loop per process.
        wall, lat, counts = c.run(drive_rpcs(d.grpc_address, per_client),
                                  timeout=900)
        k1, k2 = serve_kernel.launches, cms_kernel.launches
        del d.service.note_traffic
        c.run(control_key(d.grpc_address))
        n = clients * rpcs * RPC_REQS
        if sum(counts) != n or k1 == 0 or k2 == 0:
            raise AssertionError(f"{mode}: {sum(counts)} of {n} answers, "
                                 f"K1 launches {k1}, K2 launches {k2}")
        p50, p99, p999 = percentiles_ms(lat)
        log(f"phase 10/11 ({smi}): {mode} on {slots} slots: {clients} "
            f"clients x {rpcs} RPCs x {RPC_REQS}: {n / wall:.1f} "
            f"decisions/s through gRPC; per-RPC latency p50 {p50:.3f} ms, "
            f"p99 {p99:.3f} ms, p99.9 {p999:.3f} ms (host clock); K1 "
            f"launches {k1}, K2 launches {k2}; fast lane served "
            f"{fp.served}, fallbacks {fp.fallbacks}, blocking fetches "
            f"{fp.blocking_fetches}")
        lanes = fp.debug_vars()["lanes"]
        log(f"phase 10/11: {mode} host split (ms in each fast-lane stage, "
            "summed over merges): " + "; ".join(
                f"{lane} {v['drains']} merges, dispatch "
                f"{v['dispatch_ms_total']:.1f}, fetch {v['fetch_ms_total']:.1f}"
                f", waiting for a fetch slot {v['bubble_ms_total']:.1f}"
                for lane, v in lanes.items()))
        calls, note_s, _, note_cpu = spent["note_traffic"]
        merges = max(lanes.get("mach", {}).get("drains", 0), 1)
        log(f"phase 10/11: {mode} hot-key plane: note_traffic {calls} calls "
            f"of {RPC_REQS} requests, per machinery-lane merge "
            f"{note_s * 1e3 / merges:.4f} ms host wall ({note_s * 1e3:.3f} "
            f"ms in all, {note_s * 1e3 / max(calls, 1):.4f} a call, waits "
            f"for the interpreter lock included) and "
            f"{note_cpu * 1e3 / merges:.4f} ms of the calling thread's CPU "
            f"({note_cpu * 1e3 / max(calls, 1):.4f} a call), over {merges} "
            f"merges")
        if profile:
            profile_daemon(c, d, rng, clients)
        rec.close()
        if fp.fallbacks != 0:
            raise AssertionError(f"{mode}: {fp.fallbacks} fast-lane "
                                 "fallbacks")
        ring = fp._ring
        if ring is not None:
            if ring.seq_mismatches or sum(fp.blocking_fetches.values()):
                raise AssertionError(
                    f"{mode}: seq mismatches {ring.seq_mismatches}, "
                    f"blocking fetches {fp.blocking_fetches}")
            log(f"phase 10/11: {mode} ring: {ring.iterations} iterations "
                f"({ring.mega_iterations} mega), {ring.rounds_per_dispatch():.2f}"
                f" rounds a dispatch, {ring.host_jobs} host jobs (cascade "
                f"merges and sketch fetches), seq {ring.seq}, seq mismatches 0")
        err = rec.replay(dev, table, sketch)
        log(f"phase 10/11: {mode}: {len(rec.k1)} K1 and {len(rec.k2)} K2 "
            f"dispatches replayed through the plain versions: responses, "
            f"table, sketch bit-exact, claim words restored; control key "
            f"exact on the wire")
        if after is not None:
            err = max(err, after(c, d))
        require_planes_inactive(f"phase 10/11 ({mode})", c.daemons)
        return err, k1, k2
    finally:
        c.stop()


def profile_daemon(c, d, rng, clients):
    """About a second of serving under torch.profiler: the device's busy
    share and the device time of each kernel and copy per RPC."""
    import asyncio

    import torch
    from torch.profiler import ProfilerActivity, profile

    per_client = [rpc_requests(rng, PROFILE_RPCS, first_key=2_000_000 + j)
                  for j in range(clients)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _, counts = c.run(drive_rpcs(d.grpc_address, per_client),
                                timeout=300)
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    n_rpc = len(counts)
    if not spans:
        log("phase 10: torch.profiler recorded no device time: device "
            "busy share not measured")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"phase 10: torch.profiler, {n_rpc} RPCs in {wall * 1e3:.3f} ms "
        f"wall: device busy {busy_us / 1e3:.4f} ms "
        f"({busy_us / 1e3 / (wall * 1e3):.4%}); device ms per RPC: "
        + "; ".join(f"{k} {v / n_rpc:.5f}" for k, v in top))


def daemon_path(dev, smi, after=None) -> float:
    """Phase 10: the daemon at full width in the pipelined and persistent
    modes, the table warmed to 10M live keys through K1; `after` runs on
    the persistent daemon (phases 12a and 13a-b)."""
    rng = np.random.default_rng(SEED + 500)
    err = 0.0
    for mode in ("pipelined", "persistent"):
        e, _, _ = serve_mode_run(dev, mode, DAEMON_SLOTS, DAEMON_CLIENTS,
                                 DAEMON_RPCS, rng, smi, warm=True,
                                 profile=(mode == "persistent"),
                                 after=after if mode == "persistent"
                                 else None)
        err = max(err, e)
    return err


def cluster_path(dev, smi) -> float:
    """Phase 11: classic, ring and megaround on a 2^20-slot daemon; then a
    3-node cluster against a single node on one stream, and GLOBAL keys
    through a non-owner."""
    import asyncio

    from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    rng = np.random.default_rng(SEED + 600)
    err = 0.0
    for mode in ("classic", "ring", "megaround"):
        e, _, _ = serve_mode_run(dev, mode, SMALL_SLOTS, SMALL_CLIENTS,
                                 SMALL_RPCS, rng, smi)
        err = max(err, e)

    stream = rpc_requests(rng, CLUSTER_RPCS)

    def strip(raw):
        out = []
        for r in pb.GetRateLimitsResp.FromString(raw).responses:
            md = dict(r.metadata)
            md.pop("owner", None)
            out.append((r.status, r.limit, r.remaining, r.reset_time,
                        r.error, tuple(sorted(md.items()))))
        return out

    async def sequential(addr, payloads):
        import grpc

        async with grpc.aio.insecure_channel(addr) as ch:
            return [await ch.unary_unary(V1_RPC)(p, timeout=120)
                    for p in payloads]

    answers = []
    for n in (3, 1):
        c = start_daemons(dev, n, SMALL_SLOTS, "pipelined")
        try:
            serve_kernel.launches = cms_kernel.launches = 0
            raw = c.run(sequential(c.addresses()[0], stream), timeout=300)
            answers.append([strip(x) for x in raw])
            k1, k2 = serve_kernel.launches, cms_kernel.launches
            log(f"phase 11: {n}-node run: K1 launches {k1}, K2 launches "
                f"{k2}")
            if k1 == 0 or k2 == 0:
                raise AssertionError(f"{n}-node run: K1 launches {k1}, K2 "
                                     f"launches {k2}")
            if n == 3:
                fwd = sum(1 for x in raw for r in
                          pb.GetRateLimitsResp.FromString(x).responses
                          if "owner" in r.metadata)
                glob = [pb.RateLimitReq(
                    name="global", unique_key=f"g{i}", hits=1, limit=100,
                    duration=60_000, behavior=2) for i in range(64)]
                owners = {c.daemons[0].service.get_peer(
                    f"global_g{i}").info().grpc_address for i in range(64)}
                greq = pb.GetRateLimitsReq(requests=glob).SerializeToString()
                g1, g2 = (pb.GetRateLimitsResp.FromString(x).responses
                          for x in c.run(sequential(
                              c.addresses()[0], [greq, greq])))
                bad = [r for r in list(g1) + list(g2)
                       if r.error or r.limit != 100]
                remote = sum(1 for r in g2 if r.metadata.get("owner"))
                if bad or remote == 0 or len(owners) < 2:
                    raise AssertionError(
                        f"GLOBAL through node 0: {len(bad)} bad answers, "
                        f"{remote} from replicas, {len(owners)} owners")
                require_planes_inactive("phase 11 (3-node cluster)",
                                        c.daemons)
                log(f"phase 11: 3-node cluster ({SMALL_SLOTS} slots each, "
                    f"pipelined): {CLUSTER_RPCS} RPCs through node 0, "
                    f"{fwd} answers forwarded to other owners; 128 GLOBAL "
                    f"checks through node 0 answered ({remote} of the "
                    f"second 64 from node 0's replica)")
        finally:
            c.stop()
    if answers[0] != answers[1]:
        diff = sum(a != b for x, y in zip(*answers) for a, b in zip(x, y))
        raise AssertionError(f"cluster answers differ from a single "
                             f"node's in {diff} places")
    log(f"phase 11: the cluster's {CLUSTER_RPCS * RPC_REQS} answers equal "
        f"a single node's on the same stream (owner metadata aside)")
    return err


# -- phases 12-13: persistence and the state plane ----------------------------
LOADER_ITEMS = 1_000_000     # phase 12: Loader restore (Python objects)
STORE_KEYS = 150_000         # keys of each pool the Store traffic draws from
STORE_CLIENTS = 64
STORE_RPCS = 3
TIER_HIGH, TIER_LOW = 0.50, 0.45
TIER_BATCH = 32768           # rows per demote dispatch
COLD_CAPACITY = 4_000_000
PROMOTE_KEYS = 65_536
RESHARD_KEYS = 1_000_000     # live keys warmed across the 2-node ring
RESHARD_CHECKS = 1000
# ReshardConfig.timeout_s of the reshard cluster.  The sender's deadline
# covers its whole transfer, not a silence (ROADMAP queue 3), and here the
# three daemons share one interpreter lock: a handoff of ~160K rows in
# 1024-row chunks (the default) has overrun the default 10 s on the card's
# host.
RESHARD_TIMEOUT_S = 120.0
OP_ITERS = 10                # timed dispatches per state-plane op
STATE_OPS = ("load_rows", "probe_batch", "gather_rows", "migrate_extract",
             "migrate_inject", "demote_extract", "table_stats")
MUTATING = ("load_rows", "migrate_extract", "migrate_inject",
            "demote_extract")
ROW_FIELDS = ("kind", "algo", "limit", "duration", "remaining",
              "remaining_f", "t0", "status", "burst", "expire_at")


def require_launches(label: str, k2: bool) -> None:
    """The run since the counters were set to 0 launched K1 (and K2 when
    `k2`): the path went through the kernels."""
    from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel

    k1n, k2n = serve_kernel.launches, cms_kernel.launches
    if k1n == 0 or (k2 and k2n == 0):
        raise AssertionError(f"{label}: K1 launches {k1n}, K2 launches "
                             f"{k2n}")
    log(f"{label}: K1 launches {k1n}, K2 launches {k2n}")


# The state-plane ops each path must launch at least once.
STATE_PATH_OPS = {
    "checkpoint+census": ("table_stats",),
    "tier": ("demote_extract", "migrate_inject"),
    "store": ("load_rows", "gather_rows"),
    "reshard": ("migrate_extract", "migrate_inject"),
}


def _map_tensors(x, fn):
    """x with fn applied to every tensor inside (tuples, NamedTuples)."""
    import torch

    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        vals = [_map_tensors(v, fn) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _bits_equal(a, b) -> bool:
    """Bitwise equality of nested outputs (float64 compared as bits)."""
    import torch

    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float64:
            a, b = a.view(torch.int64), b.view(torch.int64)
        return a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_bits_equal, a, b))
    return a == b


class StateOpRecorder:
    """Counts every state-plane op the backends dispatch (the torch ops of
    ops/step.py and ops/state.py, called through runtime/backend.py) and
    keeps the first, the second and the latest dispatch of each kind: a
    copy of its input table and arguments, its outputs and, for the ops
    that write, the table after it.  `replay()` runs each kept dispatch
    again through the same op on CPU copies of its inputs and requires
    outputs and table bit-equal.  A DispatchRecorder registered in
    `sinks` also gets each op on its table, in order with K1."""

    def __init__(self):
        import threading
        from concurrent.futures import ThreadPoolExecutor

        from gubernator_tpu_torch.runtime import backend as bmod

        self.bmod = bmod
        self.orig = {n: getattr(bmod, n) for n in STATE_OPS}
        self.lock = threading.Lock()
        self.launches = {n: 0 for n in STATE_OPS}
        self.kept = {n: [] for n in STATE_OPS}
        self.last = {}
        self.sinks = {}
        # The first two dispatches' copies go to the host on a thread of
        # their own, so the dispatch (and the backend lock around it) does
        # not wait for gigabytes of device-to-host copy.
        self.spill = ThreadPoolExecutor(1, thread_name_prefix="state-spill")
        for n in STATE_OPS:
            setattr(bmod, n, self._wrap(n))

    def close(self):
        for n, fn in self.orig.items():
            setattr(self.bmod, n, fn)
        self.spill.shutdown()

    @staticmethod
    def _to_host(event, rec):
        """`rec` on the host once the stream that made it reaches `event`."""
        event.synchronize()
        return _map_tensors(rec, lambda t: t.cpu())

    def _wrap(self, name):
        import torch

        from gubernator_tpu_torch.ops.state import clone_table

        fn = self.orig[name]
        mutating = name in MUTATING

        def op(table, *args):
            with self.lock:
                i = self.launches[name]
                self.launches[name] += 1
            before = clone_table(table)
            cargs = _map_tensors(args, lambda t: t.clone())
            sink = self.sinks.get(table.key.data_ptr())
            if sink is not None:
                sink.seq.append(("op", name, cargs))
            out = fn(table, *args)
            res = out if not mutating else (
                () if name == "load_rows" else out[1:])
            rec = (before, cargs, _map_tensors(res, lambda t: t.clone()),
                   clone_table(table) if mutating else None)
            if i < 2:
                event = torch.cuda.Event()
                # On the current stream, the backend's: the op ran on it.
                event.record()
                fut = self.spill.submit(self._to_host, event, rec)
                with self.lock:
                    self.kept[name].append(fut)
            else:
                with self.lock:
                    self.last[name] = rec
            return out

        return op

    def counts(self):
        with self.lock:
            return dict(self.launches)

    def replay(self, label: str) -> int:
        """Replay the kept dispatches on the CPU; forget them."""
        from gubernator_tpu_torch.ops.state import clone_table

        with self.lock:
            todo = [(n, f) for n in STATE_OPS for f in self.kept[n]]
            last = [(n, self.last[n]) for n in STATE_OPS if n in self.last]
            self.kept = {n: [] for n in STATE_OPS}
            self.last = {}
        todo = [(n, f.result()) for n, f in todo] + last
        done = {}
        t0 = time.perf_counter()
        for name, rec in todo:
            before, cargs, res, after = _map_tensors(rec, lambda t: t.cpu())
            table = clone_table(before)
            out = self.orig[name](table, *cargs)
            got = out if name not in MUTATING else (
                () if name == "load_rows" else out[1:])
            if not _bits_equal(got, res):
                raise AssertionError(f"{label}: {name} on the CPU copy gives "
                                     "other outputs than on the card")
            if not tables_equal(table, after if after is not None
                                else before):
                raise AssertionError(f"{label}: {name} on the CPU copy "
                                     "leaves another table than the card's")
            done[name] = done.get(name, 0) + 1
        log(f"{label}: state-plane dispatches replayed on CPU copies of "
            f"their inputs, outputs and tables bit-equal: {done} "
            f"({time.perf_counter() - t0:.3f} s)")
        return sum(done.values())


def live_index(snap, now):
    """(sorted fingerprints, their slots) of the live rows of a snapshot."""
    live = np.flatnonzero((snap["key"] != 0) & (snap["expire_at"] > now))
    keys = snap["key"][live]
    o = np.argsort(keys, kind="stable")
    return keys[o], live[o]


def find_rows(index, fps):
    """Slot of each fingerprint's live row, -1 where there is none."""
    keys, slots = index
    if not len(keys):
        return np.full(len(fps), -1)
    i = np.minimum(np.searchsorted(keys, fps), len(keys) - 1)
    return np.where(keys[i] == fps, slots[i], -1)


def rows_at(snap, slots):
    return {f: snap[f][slots] for f in ROW_FIELDS}


def rows_equal(a, b) -> bool:
    return all(np.array_equal(np.asarray(a[f]).view(np.int64)
                              if np.asarray(a[f]).dtype == np.float64
                              else a[f],
                              np.asarray(b[f]).view(np.int64)
                              if np.asarray(b[f]).dtype == np.float64
                              else b[f]) for f in ROW_FIELDS)


def numpy_census(snap, grid, now, ways):
    """An independent census of a host snapshot, written from the
    definitions of ops/state.table_stats."""
    key, expire, algo = snap["key"], snap["expire_at"], snap["algo"]
    nb = key.shape[0] // ways
    resident = key != 0
    alive = resident & (expire > now)
    fill = np.bincount(resident.reshape(nb, ways).sum(axis=1),
                       minlength=ways + 1)
    edges = np.asarray([1_000, 10_000, 60_000, 600_000, 3_600_000])

    def hist(values):
        idx = np.searchsorted(edges, values[alive], side="left")
        return np.bincount(idx, minlength=6).tolist()

    lim = np.maximum(snap["limit"].astype(np.float64), 1.0)
    rem = np.where(algo == 1, snap["remaining_f"],
                   snap["remaining"].astype(np.float64))
    fbin = np.minimum((np.clip(rem / lim, 0.0, 1.0) * 8).astype(np.int64), 7)
    frac = [np.bincount(fbin[alive & (algo == a)], minlength=8).tolist()
            for a in (0, 1)]
    shadow = []
    for plane in grid:
        n = 0
        for fp in plane[plane != 0]:
            b = int(np.uint64(fp) & np.uint64(nb - 1))
            row = slice(b * ways, (b + 1) * ways)
            n += bool(((key[row] == fp) & (expire[row] > now)).any())
        shadow.append(n)
    return {"occupancy": int(resident.sum()), "live": int(alive.sum()),
            "expired_resident": int((resident & ~alive).sum()),
            "bucket_fill": fill.tolist(), "slot_age": hist(now - snap["t0"]),
            "ttl_remaining": hist(expire - now), "remaining_fraction": frac,
            "shadow_slots": shadow}


def http_json(addr, path):
    import urllib.request

    with urllib.request.urlopen(f"http://{addr}{path}", timeout=60) as r:
        return json.loads(r.read())


async def send_sequential(addr, payloads):
    import grpc

    async with grpc.aio.insecure_channel(addr) as ch:
        return [await ch.unary_unary(V1_RPC)(p, timeout=300)
                for p in payloads]


def time_calls(obj, name, spent):
    """Wrap the method `name` of `obj` so that each call adds one call, its
    host seconds and the calling thread's CPU seconds to spent[name] =
    [calls, seconds, lock, CPU seconds]."""
    import threading

    fn = getattr(obj, name)
    acc = spent.setdefault(name, [0, 0.0, threading.Lock(), 0.0])

    def timed(*a, **k):
        t, c0 = time.perf_counter(), time.thread_time()
        try:
            return fn(*a, **k)
        finally:
            with acc[2]:
                acc[0] += 1
                acc[1] += time.perf_counter() - t
                acc[3] += time.thread_time() - c0

    setattr(obj, name, timed)


def bulk_load(be, cols, now):
    """Upsert host row columns (BucketRows names) into a backend's table,
    batch_size rows a dispatch, through the backend's load_rows.  A
    dispatch resolves at most INSERT_ROUNDS inserts a bucket, so rows go
    in waves in which no bucket has more than that."""
    from gubernator_tpu_torch.ops.step import INSERT_ROUNDS
    from gubernator_tpu_torch.runtime import backend as bmod

    nb = np.uint64(be.cfg.num_slots // be.cfg.ways - 1)
    bucket = cols["key_hash"].view(np.uint64) & nb
    order = np.argsort(bucket, kind="stable")
    sb = bucket[order]
    starts = np.flatnonzero(np.r_[True, sb[1:] != sb[:-1]])
    rank = np.empty(len(sb), dtype=np.int64)
    rank[order] = np.arange(len(sb)) - np.repeat(
        starts, np.diff(np.r_[starts, len(sb)]))
    wave = rank // INSERT_ROUNDS
    with be._lock, be._on_stream():
        for w in range(int(wave.max()) + 1 if len(wave) else 0):
            sel = np.flatnonzero(wave == w)
            for lo in range(0, len(sel), be.cfg.batch_size):
                bmod.load_rows(be.table, be._upload_rows(
                    cols, sel[lo:lo + be.cfg.batch_size]), now, be.cfg.ways)


def phase_checkpoint(c, d, dev, smi, state) -> float:
    """Phase 12a: save phase 10's served table and sketch, restore them
    into a fresh daemon, and serve both the same RPCs."""
    import shutil
    import tempfile

    import torch

    from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel
    from gubernator_tpu_torch.ops.sketch import clone_sketch
    from gubernator_tpu_torch.ops.state import clone_table
    from gubernator_tpu_torch.runtime.checkpoint import TableCheckpointer

    be, sb = d.service.backend, d.service.sketch_backend
    tmp = tempfile.mkdtemp(prefix="gubernator-ckpt-")
    d2 = None
    try:
        ck = TableCheckpointer(tmp)
        ck.save(be, step=1, sketch=sb)
        sv = ck.last_save
        # A fresh daemon of the same configuration, on the same loop (one
        # grpc.aio loop a process).
        d2 = c.boot(d.conf.device, d.conf)
        be2, sb2 = d2.service.backend, d2.service.sketch_backend
        t0 = time.perf_counter()
        TableCheckpointer(tmp).restore(be2, sketch=sb2)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        a, b = be.snapshot(), be2.snapshot()
        if not all(np.array_equal(a[f].view(np.uint8), b[f].view(np.uint8))
                   for f in a):
            raise AssertionError("restored table differs from the saved one")
        if not sketch_equal(sb.state, sb2.state):
            raise AssertionError("restored sketch differs from the saved one")
        gb = sv["bytes"] / 1e9
        log(f"phase 12 ({smi}): checkpoint of {be.cfg.num_slots} slots and "
            f"the sketch, {gb:.3f} GB: save {sv['seconds']:.3f} s "
            f"({gb / sv['seconds']:.3f} GB/s, the backend lock held "
            f"{sv['lock_s'] * 1e3:.3f} ms), restore {restore_s:.3f} s "
            f"({gb / restore_s:.3f} GB/s); restored table and sketch "
            f"byte-equal")
        rng = np.random.default_rng(SEED + 700)
        payloads = rpc_requests(rng, 8, first_key=3_000_000)
        recs, starts, answers = [], [], []
        for dd in (d, d2):
            b_, s_ = dd.service.backend, dd.service.sketch_backend
            torch.cuda.synchronize()
            starts.append((clone_table(b_.table), clone_sketch(s_.state)))
            recs.append(DispatchRecorder(b_, s_, state))
            serve_kernel.launches = cms_kernel.launches = 0
            answers.append(c.run(send_sequential(dd.grpc_address,
                                                 payloads), timeout=300))
            require_launches("phase 12 (checkpoint)", k2=True)
        err = 0.0
        for rec, (t, sk) in zip(recs, starts):
            rec.close()
            err = max(err, rec.replay(dev, t, sk))
        if answers[0] != answers[1]:
            raise AssertionError("the restored daemon answers differently")
        require_planes_inactive("phase 12 (restored daemon)", [d2])
        log(f"phase 12: 8 RPCs of {RPC_REQS} (PERF.md §4 mix, 1/8 sketch) "
            f"byte-equal on the wire from the saved and the restored "
            f"daemon; {len(recs[0].k1)}+{len(recs[1].k1)} K1 and "
            f"{len(recs[0].k2)}+{len(recs[1].k2)} K2 dispatches replayed "
            f"bit-exact")
        return err
    finally:
        if d2 is not None:
            c.run(d2.close(), timeout=120)
        shutil.rmtree(tmp, ignore_errors=True)


def phase_gubstat(c, d, dev, smi, state):
    """Phase 13a: the census of phase 10's warmed table against a numpy
    census, the sampler's /debug/vars block, /debug/key of the control
    key."""
    from gubernator_tpu_torch.core.hashing import bulk_key_hash64
    from gubernator_tpu_torch.runtime.gubstat import AGE_BIN_LABELS

    be = d.service.backend
    sampler = d.stats_sampler
    grid = sampler._shadow_grid()
    st = be.table_stats_dispatch(grid)()
    snap = be.snapshot()
    now = be.clock.millisecond_now()
    ref = numpy_census(snap, grid, now, WAYS)
    got = {f: np.asarray(getattr(st, f))[0].tolist() for f in ref}
    if got != ref:
        bad = [f for f in ref if got[f] != ref[f]]
        raise AssertionError(f"census differs from numpy in {bad}")
    c.run(sampler.sample(), timeout=120)
    block = http_json(d.http_address, "/debug/vars")["table"]
    view = {
        "occupancy": block["occupancy"], "live": block["live"],
        "expired_resident": block["expired_resident"],
        "bucket_fill": block["bucket_fill"],
        "slot_age": [block["slot_age_ms"][k] for k in AGE_BIN_LABELS],
        "ttl_remaining": [block["ttl_remaining_ms"][k]
                          for k in AGE_BIN_LABELS],
        "remaining_fraction": [block["remaining_fraction"]["token"],
                               block["remaining_fraction"]["leaky"]],
        "shadow_slots": list(block["shadow_slots"].values()),
    }
    if view != ref:
        raise AssertionError("/debug/vars table block differs from the "
                             "numpy census")
    key = http_json(d.http_address, "/debug/key?name=control&key=driven")
    slot = find_rows(live_index(snap, now),
                     bulk_key_hash64(["control_driven"]))[0]
    want = {"algorithm": int(snap["algo"][slot]),
            "limit": int(snap["limit"][slot]),
            "duration": int(snap["duration"][slot]),
            "remaining": float(snap["remaining"][slot]),
            "created_at": int(snap["t0"][slot]),
            "status": int(snap["status"][slot]),
            "burst": int(snap["burst"][slot]),
            "expire_at": int(snap["expire_at"][slot]),
            "key": "control_driven"}
    if slot < 0 or not key["found"] or key["row"] != want:
        raise AssertionError(f"/debug/key control row: {key}")
    log(f"phase 13: table_stats on {be.cfg.num_slots} slots equals a numpy "
        f"census of snapshot() and the sampler's /debug/vars block "
        f"(occupancy {ref['occupancy']}, live {ref['live']}, expired "
        f"{ref['expired_resident']}, bucket fill {ref['bucket_fill']}); "
        f"/debug/key decodes control_driven exactly (remaining "
        f"{want['remaining']}, status {want['status']})")
    return snap, now


def time_state_ops(dev, name, smi, be, state, snap, now):
    """Device ms per dispatch of each state-plane op at the main path's
    shapes on the warmed table (CUDA events, the table restored and L2
    flushed before each), beside its byte bound."""
    import torch

    from gubernator_tpu_torch.ops.state import clone_table
    from gubernator_tpu_torch.ops.step import BucketRows

    ops = state.orig
    S, B = be.cfg.num_slots, BATCH
    rate = hbm_bytes_per_s(name)
    rng = np.random.default_rng(SEED + 800)
    live = np.flatnonzero((snap["key"] != 0) & (snap["expire_at"] > now))
    present = snap["key"][rng.choice(live, B, replace=False)]
    absent = rng.integers(1, 2**62, B)
    h = torch.from_numpy(np.where(rng.random(B) < 0.5, present,
                                  absent)).to(dev)
    found = int(np.isin(h.cpu().numpy(), present).sum())

    def rows(n, keys):
        return BucketRows(
            key_hash=torch.from_numpy(keys[:n]).to(dev),
            algo=torch.zeros(n, dtype=torch.int32, device=dev),
            limit=torch.full((n,), 100, dtype=torch.int64, device=dev),
            duration=torch.full((n,), 3_600_000, dtype=torch.int64,
                                device=dev),
            remaining=torch.full((n,), 50, dtype=torch.int64, device=dev),
            remaining_f=torch.zeros(n, dtype=torch.float64, device=dev),
            t0=torch.full((n,), now, dtype=torch.int64, device=dev),
            status=torch.zeros(n, dtype=torch.int32, device=dev),
            burst=torch.zeros(n, dtype=torch.int64, device=dev),
            expire_at=torch.full((n,), now + 3_600_000, dtype=torch.int64,
                                 device=dev))

    chunk = min(1024, B)  # ReshardConfig.chunk_rows: one Migrate chunk
    mix = np.where(np.arange(chunk) % 2 == 0, present[:chunk],
                   absent[:chunk])
    grid = torch.zeros((5, 8), dtype=torch.int64, device=dev)
    protect = torch.zeros(8, dtype=torch.int64, device=dev)
    pristine = clone_table(be.table)
    work = clone_table(pristine)
    l2 = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():
        for x, y in zip(work, pristine):
            x.copy_(y)
        l2.zero_()

    probe = B * (8 + 16 * WAYS) + B * 9
    cases = [
        ("probe_batch", lambda: ops["probe_batch"](work, h, now, WAYS),
         probe, f"B={B}"),
        ("gather_rows", lambda: ops["gather_rows"](work, h, now, WAYS),
         probe + found * 60 + B * 88, f"B={B}, {found} found"),
        ("load_rows", lambda: ops["load_rows"](work, rows(B, absent), now,
                                              WAYS),
         B * (80 + 24 * WAYS + 96), f"B={B} fresh rows"),
        ("migrate_extract", lambda: ops["migrate_extract"](
            work, h[:chunk], now, WAYS),
         chunk * (8 + 16 * WAYS + 88) + chunk // 2 * (60 + 16),
         f"B={chunk}"),
        ("migrate_inject", lambda: ops["migrate_inject"](
            work, rows(chunk, mix), now, WAYS),
         chunk * (80 + 40 * WAYS + 1) + chunk // 2 * (96 + 32),
         f"B={chunk}, half resident"),
        ("demote_extract", lambda: ops["demote_extract"](
            work, protect, now, WAYS, TIER_BATCH),
         28 * S + TIER_BATCH * (80 + 88 + 16), f"batch={TIER_BATCH}"),
        ("table_stats", lambda: ops["table_stats"](work, grid, now, WAYS),
         52 * S, f"S={S}"),
    ]
    out = {}
    for op_name, fn, nbytes, shape in cases:
        flush()
        fn()
        ms = cuda_ms(fn, OP_ITERS, flush)
        bound = nbytes / rate * 1e3
        out[op_name] = {"ms": ms, "bound_ms": bound, "shape": shape}
        log(f"phase 13 ({smi}): {op_name} ({shape}): {ms:.4f} ms a "
            f"dispatch, byte bound {bound:.4f} ms ({nbytes} B at "
            f"{rate / 1e12:.2f} TB/s)")
    del work, pristine, l2
    torch.cuda.synchronize()
    return out


def phase_tier(c, d, dev, smi, snap, now):
    """Phase 13b: arm the cold tier on phase 10's warmed table, demote to
    the low mark, check both tiers, promote PROMOTE_KEYS keys back."""
    from gubernator_tpu_torch.core.config import TierConfig
    from gubernator_tpu_torch.runtime.coldtier import TierManager

    be = d.service.backend
    tm = TierManager(d.service, TierConfig(
        enabled=True, high_water=TIER_HIGH, low_water=TIER_LOW,
        demote_batch=TIER_BATCH, cold_capacity=COLD_CAPACITY),
        fastpath=d.fastpath, metrics=d.metrics)
    live_before = int(((snap["key"] != 0) & (snap["expire_at"] > now)).sum())
    need = tm.demote_need(int((snap["key"] != 0).sum()))
    # One tick drains to the low mark: the daemon's worker would spread
    # these passes over several ticks of MAX_DEMOTE_PASSES each.
    tm.MAX_DEMOTE_PASSES = need // TIER_BATCH + 8
    log(f"phase 13: tier armed on {be.cfg.num_slots} slots, {need} rows "
        f"over the low mark")
    t0 = time.perf_counter()
    demoted, ticks = 0, 0
    while True:
        n = tm.demote_once_sync()
        ticks += 1
        demoted += n
        if n == 0:
            break
    demote_s = time.perf_counter() - t0
    after = be.snapshot()
    cold = tm.cold.snapshot()
    live_after = int(((after["key"] != 0) & (after["expire_at"] > now)).sum())
    if demoted != need or live_after + tm.cold.residents() != live_before:
        raise AssertionError(
            f"tier: demoted {demoted} of {need}; {live_after} live + "
            f"{tm.cold.residents()} cold != {live_before} before")
    if np.isin(cold["key_hash"], live_index(after, now)[0]).any():
        raise AssertionError("a fingerprint is in both tiers")
    pre = find_rows(live_index(snap, now), cold["key_hash"])
    if (pre < 0).any() or not rows_equal(
            rows_at(snap, pre), {"kind": np.zeros(len(pre), np.int32),
                                 **{f: cold[f] for f in ROW_FIELDS
                                    if f != "kind"}}):
        raise AssertionError("a demoted row differs from its pre-demote row")
    log(f"phase 13 ({smi}): tier high {TIER_HIGH} low {TIER_LOW}, batch "
        f"{TIER_BATCH}: {demoted} rows demoted in {tm.demote_passes} "
        f"dispatches over {ticks} ticks, {demote_s:.3f} s "
        f"({demoted / demote_s:.1f} rows/s, "
        f"{demote_s / tm.demote_passes * 1e3:.3f} ms a pass, host clock); "
        f"live {live_before} -> {live_after} + {tm.cold.residents()} cold; "
        f"no fingerprint in both tiers; every demoted row equals its "
        f"pre-demote row")
    rng = np.random.default_rng(SEED + 900)
    pick = rng.choice(len(cold["key_hash"]), PROMOTE_KEYS, replace=False)
    fps = cold["key_hash"][pick]
    want = {f: cold[f][pick] for f in ROW_FIELDS if f != "kind"}
    t0 = time.perf_counter()
    tm.note_access(fps, np.ones(len(fps), dtype=np.int64))
    promoted = tm.drain_promotes_sync()
    promote_s = time.perf_counter() - t0
    back = be.snapshot()
    slots = find_rows(live_index(back, now), fps)
    if promoted != len(fps) or (slots < 0).any() or not rows_equal(
            rows_at(back, slots), {"kind": np.zeros(len(fps), np.int32),
                                   **want}):
        raise AssertionError(f"tier: {promoted} of {len(fps)} promoted "
                             "rows came back as their cold rows")
    log(f"phase 13: promoted {promoted} demoted keys (note_access + "
        f"drain_promotes_sync) in {promote_s * 1e3:.3f} ms (host clock), "
        f"each equal to its cold row (none had a fresh row to merge with); "
        f"promote latency p99 bucket {tm.debug_vars()['promote_latency']['p99_s']}")
    tier_lane_promote(c, d, tm)


# Named keys written before the census so that the tier demotes some: every
# row is stamped at the frozen instant, so a demote pass takes the live rows
# in slot order, and these sit in the first 1/16 of the buckets.
TIER_KEYS = 64
TIER_KEY_HITS = 3


def tier_key_names(be):
    from gubernator_tpu_torch.core.hashing import bulk_key_hash64

    nb = np.uint64(be.cfg.num_slots // be.cfg.ways)
    out, i = [], 0
    while len(out) < TIER_KEYS:
        names = [f"tk{j}" for j in range(i, i + 4096)]
        b = bulk_key_hash64([f"tier_{n}" for n in names]).view(np.uint64) % nb
        out += [n for n, x in zip(names, b) if x < nb // np.uint64(16)]
        i += 4096
    return out[:TIER_KEYS]


def tier_payload(names, hits):
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    return pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
        name="tier", unique_key=n, hits=hits, limit=100,
        duration=3_600_000) for n in names]).SerializeToString()


def plant_tier_keys(c, d):
    """TIER_KEYS named token keys, TIER_KEY_HITS hits each, on the wire."""
    c.run(send_sequential(d.grpc_address, [tier_payload(
        tier_key_names(d.service.backend), TIER_KEY_HITS)]), timeout=120)


def tier_lane_promote(c, d, tm):
    """Phase 13b under the defaults: one demoted key checked through the
    compiled lane answers from a fresh row, the lane's note_traffic (hot
    keys on) queues its promote, and the promote merges the cold row's
    consumption: the served row then holds the cold hits plus the new."""
    from gubernator_tpu_torch.core.hashing import bulk_key_hash64
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    names = tier_key_names(d.service.backend)
    fps = bulk_key_hash64([f"tier_{n}" for n in names])
    cold = np.flatnonzero(tm.cold.member_hits(fps))
    if not len(cold):
        raise AssertionError("tier: none of the planted keys was demoted")
    name = names[int(cold[0])]
    snap = tm.cold.snapshot()
    row = np.flatnonzero(snap["key_hash"] == fps[int(cold[0])])[0]
    cold_used = 100 - int(snap["remaining"][row])
    fp = d.fastpath
    served, fallbacks, hits0 = fp.served, fp.fallbacks, tm.cold_hits
    d.service.tier = tm
    try:
        raw = c.run(send_sequential(d.grpc_address,
                                    [tier_payload([name], 2)]))[0]
        resp = pb.GetRateLimitsResp.FromString(raw).responses[0]
        queued = tm.cold_hits - hits0
        promoted = tm.drain_promotes_sync()
    finally:
        d.service.tier = None
    item = d.service.backend.get_cache_item(f"tier_{name}")
    if (fp.served != served + 1 or fp.fallbacks != fallbacks
            or resp.error or resp.remaining != 100 - 2 or queued != 1
            or promoted != 1 or cold_used != TIER_KEY_HITS
            or int(item.remaining) != 100 - cold_used - 2):
        raise AssertionError(
            f"tier: compiled-lane promote of tier_{name}: served "
            f"{fp.served - served}, fallbacks {fp.fallbacks - fallbacks}, "
            f"answer {resp.remaining} {resp.error!r}, queued {queued}, "
            f"promoted {promoted}, cold used {cold_used}, row "
            f"{item and item.remaining}")
    log(f"phase 13: {len(cold)} of {TIER_KEYS} planted keys demoted; "
        f"tier_{name} checked through the compiled lane with 2 hits answered "
        f"remaining {resp.remaining} from a fresh row, its note_traffic "
        f"queued 1 promote, and the promote merged the cold row's "
        f"{cold_used} hits: the row holds remaining {int(item.remaining)} "
        f"= 100 - {cold_used} - 2")


def phase10_state(state, dev, name, smi, times):
    """Phases 12a and 13a-b on phase 10's persistent daemon."""
    def after(c, d):
        plant_tier_keys(c, d)
        before = state.counts()
        err = phase_checkpoint(c, d, dev, smi, state)
        snap, now = phase_gubstat(c, d, dev, smi, state)
        times.update(time_state_ops(dev, name, smi, d.service.backend,
                                    state, snap, now))
        mid = state.counts()
        phase_tier(c, d, dev, smi, snap, now)
        end = state.counts()
        STATE_PATHS["checkpoint+census"] = {
            k: mid[k] - before[k] for k in STATE_OPS}
        STATE_PATHS["tier"] = {k: end[k] - mid[k] for k in STATE_OPS}
        log("phase 12-13: state-plane launches, checkpoint and census: "
            + json.dumps(STATE_PATHS["checkpoint+census"]) + "; tier: "
            + json.dumps(STATE_PATHS["tier"]))
        state.replay("phase 12-13 (checkpoint, census, tier)")
        return err

    return after


def phase_store(dev, smi, state) -> float:
    """Phase 12b: a pipelined 2^24-slot daemon with a Loader of
    LOADER_ITEMS items and a Store; Store traffic; write-through and the
    Loader save checked against the table."""
    import torch

    from gubernator_tpu_torch.core.types import Algorithm, CacheItem, Status
    from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel
    from gubernator_tpu_torch.ops.state import KIND_CACHED_RESP, clone_table
    from gubernator_tpu_torch.ops.sketch import clone_sketch
    from gubernator_tpu_torch.runtime import backend as bmod
    from gubernator_tpu_torch.runtime import fastpath as fmod
    from gubernator_tpu_torch.runtime.store import MockLoader, MockStore

    now = T0_NS // 1_000_000
    rng = np.random.default_rng(SEED + 1000)
    names = ["api", "login", "search", "upload"]

    def item(u, expire):
        leaky = u % 3 == 0
        limit = (10, 100, 1000)[u % 3 if not leaky else (u // 3) % 3]
        return CacheItem(
            key=f"{names[u % 4]}_tenant{u % 97}:user{u}",
            algorithm=Algorithm.LEAKY_BUCKET if leaky
            else Algorithm.TOKEN_BUCKET,
            expire_at=int(expire), limit=limit,
            duration=(1000, 60_000)[u % 2],
            remaining=limit / 2 + 0.25 if leaky else limit // 2,
            created_at=now - 1_000, status=Status.UNDER_LIMIT)

    expire = now + 60_000 * rng.integers(1, 61, LOADER_ITEMS)
    log(f"phase 12: building {LOADER_ITEMS} Loader items")
    t0 = time.perf_counter()
    loader = MockLoader([item(u, expire[u]) for u in range(LOADER_ITEMS)])
    store = MockStore()
    for u in range(LOADER_ITEMS, LOADER_ITEMS + STORE_KEYS):
        it = item(u, now + 3_600_000)
        store.data[it.key] = it
    make_s = time.perf_counter() - t0
    load_s = []
    orig_load = bmod.TorchBackend.load_items

    def timed_load(self, items):
        t = time.perf_counter()
        n = orig_load(self, items)
        load_s.append((n, time.perf_counter() - t))
        return n

    bmod.TorchBackend.load_items = timed_load
    at_start = state.counts()
    try:
        c = start_daemons(dev, 1, DAEMON_SLOTS, "pipelined", loader=loader,
                          store=store)
    finally:
        bmod.TorchBackend.load_items = orig_load
    stages = {}

    def timing(owner, attr):
        fn = getattr(owner, attr)

        def wrapped(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                stages[attr] = stages.get(attr, 0.0) + time.perf_counter() - t

        setattr(owner, attr, wrapped)

    try:
        d = c.daemons[0]
        be, sb, fp = d.service.backend, d.service.sketch_backend, d.fastpath
        n_loaded, restore_s = load_s[0]
        log(f"phase 12 ({smi}): Loader restore of {n_loaded} items into "
            f"{be.cfg.num_slots} slots: {restore_s:.3f} s "
            f"({n_loaded / restore_s:.1f} items/s; the {LOADER_ITEMS} "
            f"CacheItems took {make_s:.3f} s to build); occupancy "
            f"{be.occupancy()}")
        for attr in ("_persist_decode", "_repair_cold_store_keys",
                     "_build_captured"):
            timing(fp, attr)
        for attr in ("_gather_rows_dispatch", "_deliver_write_through"):
            timing(be, attr)
        pools = np.concatenate([rng.integers(0, STORE_KEYS, STORE_KEYS),
                                LOADER_ITEMS + np.arange(STORE_KEYS)])
        per_client = [rpc_requests(rng, STORE_RPCS, pool=pools)
                      for _ in range(STORE_CLIENTS)]
        torch.cuda.synchronize()
        table, sketch = clone_table(be.table), clone_sketch(sb.state)
        rec = DispatchRecorder(be, sb, state)
        before = state.counts()
        log("phase 12: Store traffic starts")
        serve_kernel.launches = cms_kernel.launches = 0
        wall, lat, counts = c.run(drive_rpcs(d.grpc_address, per_client),
                                  timeout=900)
        require_launches("phase 12 (Store traffic)", k2=True)
        rec.close()
        used = state.counts()
        STATE_PATHS["store"] = {k: used[k] - at_start[k] for k in STATE_OPS}
        err = rec.replay(dev, table, sketch)
        n = STORE_CLIENTS * STORE_RPCS * RPC_REQS
        if sum(counts) != n or fp.served == 0 or fp.fallbacks != 0:
            raise AssertionError(f"store run: {sum(counts)} of {n} answers, "
                                 f"served {fp.served}, fallbacks "
                                 f"{fp.fallbacks}")
        touched, peeks = store_keys_of([p for ps in per_client for p in ps])
        items = be.read_items_bulk(touched)
        bad = [k for k in touched
               if items.get(k) is None or store.data.get(k) != items[k]]
        if bad:
            raise AssertionError(
                f"{len(bad)} Store rows differ from the table, e.g. "
                f"{bad[0]}: {store.data.get(bad[0])} vs {items.get(bad[0])}")
        lanes = fp.debug_vars()["lanes"]
        disp = sum(v["dispatch_ms_total"] for v in lanes.values())
        wt = 1e3 * sum(stages.get(a, 0.0) for a in (
            "_persist_decode", "_gather_rows_dispatch",
            "_repair_cold_store_keys"))
        p50, p99, _ = percentiles_ms(lat)
        log(f"phase 12 ({smi}): Store traffic {STORE_CLIENTS} clients x "
            f"{STORE_RPCS} RPCs x {RPC_REQS} (half Loader keys, half cold "
            f"Store keys): {n / wall:.1f} decisions/s, p50 {p50:.3f} ms, "
            f"p99 {p99:.3f} ms (host clock); fast lane served {fp.served}, "
            f"fallbacks 0; Store gets {store.called['get']}, on_change "
            f"{store.called['on_change']}; {len(touched)} touched keys' "
            f"Store rows equal read_items_bulk ({peeks} keys with a "
            f"RESET_REMAINING left out); write-through "
            f"(decode {stages.get('_persist_decode', 0) * 1e3:.1f} ms, "
            f"capture dispatch "
            f"{stages.get('_gather_rows_dispatch', 0) * 1e3:.1f} ms, cold "
            f"repair {stages.get('_repair_cold_store_keys', 0) * 1e3:.1f} "
            f"ms) is {wt / max(disp, 1e-9):.1%} of the dispatch stage's "
            f"{disp:.1f} ms; capture build "
            f"{stages.get('_build_captured', 0) * 1e3:.1f} ms and delivery "
            f"{stages.get('_deliver_write_through', 0) * 1e3:.1f} ms on the "
            f"fetch stage; {len(rec.k1)} K1, {len(rec.k2)} K2 and "
            f"{sum(1 for e in rec.seq if e[0] == 'op')} state ops replayed "
            f"in order, bit-exact; state-plane launches "
            + json.dumps({k: used[k] - before[k] for k in STATE_OPS}))
        log("phase 12: checking the Loader's save")
        final = be.snapshot()
        fnow = be.clock.millisecond_now()
        keymap = dict(be._keymap)
        live = (final["key"] != 0) & (final["expire_at"] > fnow)
        tracked = np.array([int(np.int64(k).view(np.uint64)) in keymap
                            for k in final["key"][live]])
        want_keys = {keymap[int(np.int64(k).view(np.uint64))]
                     for k in final["key"][live][tracked
                                                 & (final["kind"][live]
                                                    != KIND_CACHED_RESP)]}
        require_planes_inactive("phase 12 (Store and Loader)", c.daemons)
    finally:
        c.stop()
    saved = {i.key for i in loader.contents}
    if loader.called["save"] != 1 or saved != want_keys:
        raise AssertionError(f"Loader save: {len(saved)} items, "
                             f"{len(want_keys)} live tracked bucket rows")
    log(f"phase 12: the Loader's save at close returned {len(saved)} items: "
        f"every live tracked bucket row, no cached-response row")
    state.replay("phase 12 (Store and Loader)")
    return err


def store_keys_of(payloads):
    """(sorted hash keys of the payloads' exact-tier requests, the number
    of keys left out): a key that got a RESET_REMAINING request is left
    out, because the reset clears the row without Store.remove in both
    packages, so the Store keeps the pre-reset item (ROADMAP queue 3)."""
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    keys, peeked = set(), set()
    for p in payloads:
        for r in pb.GetRateLimitsReq.FromString(p).requests:
            if r.name == "cms" or not r.unique_key:
                continue
            k = f"{r.name}_{r.unique_key}"
            keys.add(k)
            if r.behavior & 8:  # RESET_REMAINING
                peeked.add(k)
    return sorted(keys - peeked), len(peeked)


def phase_reshard(dev, smi, state) -> float:
    """Phase 13c: a 2-node cluster at 2^24 slots a node warmed to
    RESHARD_KEYS live keys, a third node joins, the moved rows arrive."""
    import torch

    from gubernator_tpu_torch.core.clock import Clock
    from gubernator_tpu_torch.core.config import DeviceConfig, ReshardConfig
    from gubernator_tpu_torch.core.hashing import bulk_key_hash64
    from gubernator_tpu_torch.core.types import RateLimitReq
    from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel
    from gubernator_tpu_torch.ops.sketch import clone_sketch
    from gubernator_tpu_torch.ops.state import clone_table
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb
    from gubernator_tpu_torch.runtime.backend import TorchBackend
    from gubernator_tpu_torch.runtime.reshard import ring_owner_indices

    now = T0_NS // 1_000_000
    ids = np.arange(RESHARD_KEYS)
    keys = [f"rs_u{i}" for i in ids.tolist()]
    fps = bulk_key_hash64(keys)
    leaky = ids % 3 == 0
    cols = {"key_hash": fps, "algo": leaky.astype(np.int32),
            "limit": np.full(RESHARD_KEYS, 100, dtype=np.int64),
            "duration": np.full(RESHARD_KEYS, 3_600_000, dtype=np.int64),
            "remaining": (ids % 97).astype(np.int64),
            "remaining_f": (ids % 97) + 0.5 * leaky,
            "t0": now - (ids % 1000),
            "status": np.zeros(RESHARD_KEYS, dtype=np.int32),
            "burst": np.where(leaky, 100, 0).astype(np.int64),
            "expire_at": now + 3_600_000 - (ids % 1000)}
    at_start = state.counts()
    c = start_daemons(dev, 2, DAEMON_SLOTS, "pipelined",
                      reshard=ReshardConfig(timeout_s=RESHARD_TIMEOUT_S))
    try:
        d0, d1 = c.daemons
        two = [d0.grpc_address, d1.grpc_address]
        peers = d0.service.local_picker.ring_arrays()[2]
        owner = np.array([two.index(p.info().grpc_address) for p in peers]
                         )[ring_owner_indices(fps, d0.service.local_picker)]
        for i, d in enumerate((d0, d1)):
            sel = owner == i
            bulk_load(d.service.backend, {f: v[sel] for f, v in cols.items()},
                      now)
        log(f"phase 13: {RESHARD_KEYS} reshard keys loaded on their owners")
        pre = [d.service.backend.snapshot() for d in (d0, d1)]
        pre_idx = [live_index(s, now) for s in pre]
        landed = sum(int((find_rows(ix, fps) >= 0).sum()) for ix in pre_idx)
        if landed != RESHARD_KEYS:
            raise AssertionError(f"{landed} of {RESHARD_KEYS} warm rows live")
        d2 = c.boot(c.daemons[0].conf.device, c.daemons[0].conf)
        three = two + [d2.grpc_address]
        spent = {}
        for d in (d0, d1, d2):
            for m in ("migrate_extract_rows", "migrate_inject_rows"):
                time_calls(d.service.backend, m, spent)
        log("phase 13: the third node joins")
        t0 = time.perf_counter()
        c.join(d2)
        deadline = time.monotonic() + 600

        def settled(d):
            rs = d.service.reshard
            return (rs.handoffs_started > 0 and rs.handoffs_started
                    == rs.handoffs_completed + rs.handoffs_aborted)

        while not (settled(d0) and settled(d1)):
            if time.monotonic() > deadline:
                raise AssertionError("handoffs did not settle")
            time.sleep(0.01)
        join_s = time.perf_counter() - t0
        rss = [d.service.reshard for d in (d0, d1)]
        if any(rs.rows_lost or rs.handoffs_aborted for rs in rss):
            raise AssertionError(f"handoffs lost rows: "
                                 f"{[rs.debug_vars() for rs in rss]}")
        new_owner = np.array([three.index(p.info().grpc_address) for p in
                              d0.service.local_picker.ring_arrays()[2]]
                             )[ring_owner_indices(
                                 fps, d0.service.local_picker)]
        moved = new_owner == 2
        sent = sum(rs.rows_sent for rs in rss)
        post2 = d2.service.backend.snapshot()
        at2 = find_rows(live_index(post2, now), fps[moved])
        # Moved rows the joiner lacks: migrate_inject_rows does not
        # spread a chunk's rows, so past three same-bucket rows of one
        # chunk (the senders stream in slot order) the rest find no claim
        # and are dropped, in both packages (ROADMAP queue 3).  Each drop
        # must be one of those.
        nb = np.uint64(DAEMON_SLOTS // WAYS - 1)
        bucket = fps.view(np.uint64) & nb
        dropped = np.flatnonzero(moved)[at2 < 0]
        for i in dropped:
            group = moved & (owner == owner[i]) & (bucket == bucket[i])
            if int(group.sum()) < 4:
                raise AssertionError(f"moved row {fps[i]} missing on the "
                                     "joiner, not past a bucket's three")
        if sent < int(moved.sum()):
            raise AssertionError(f"{sent} rows sent, {int(moved.sum())} "
                                 "moved")
        landed = np.flatnonzero(moved)[at2 >= 0]
        at2 = at2[at2 >= 0]
        pre_rows = {f: np.zeros(len(landed), dtype=pre[0][f].dtype)
                    for f in ROW_FIELDS}
        for i in (0, 1):
            sel = owner[landed] == i
            slots = find_rows(pre_idx[i], fps[landed][sel])
            for f in ROW_FIELDS:
                pre_rows[f][sel] = pre[i][f][slots]
        if not rows_equal(rows_at(post2, at2), pre_rows):
            raise AssertionError("a moved row differs from its pre-remap row")
        for i, d in enumerate((d0, d1)):
            ix = live_index(d.service.backend.snapshot(), now)
            if (find_rows(ix, fps[moved]) >= 0).any():
                raise AssertionError(f"node {i} still holds a moved row")
        win = [(d.metrics.reshard_window_duration._sum.get(),
                rs.rows_sent) for d, rs in zip((d0, d1), rss)]
        log(f"phase 13 ({smi}): reshard 2 -> 3 nodes at {DAEMON_SLOTS} slots "
            f"each, {RESHARD_KEYS} live keys: {sent} rows moved to the "
            f"joiner ({', '.join(f'{n} in {w * 1e3:.1f} ms = {n / w:.1f} rows/s' for w, n in win)} "
            f"handoff windows; deadline {RESHARD_TIMEOUT_S} s, the default "
            f"10.0), join to settled {join_s * 1e3:.1f} ms "
            f"(host clock); rows_lost 0; {len(dropped)} moved rows dropped "
            f"past a bucket's three insert claims in one chunk (ROADMAP "
            f"queue 3); the other {len(landed)} equal their pre-remap rows "
            f"but for touched; the old owners hold none")
        log("phase 13: inside the handoffs (host clock, both senders and the "
            "joiner): " + "; ".join(
                f"{m} {n} calls, {s:.3f} s ({s / max(n, 1) * 1e3:.3f} ms a "
                f"call)" for m, (n, s, _, _) in spent.items()))
        pick = np.random.default_rng(SEED + 1100).choice(
            landed, RESHARD_CHECKS, replace=False)
        reqs = [RateLimitReq(name="rs", unique_key=f"u{i}", hits=1,
                             limit=100, duration=3_600_000,
                             algorithm=int(leaky[i]),
                             burst=100 if leaky[i] else 0)
                for i in pick.tolist()]
        payload = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
            name=r.name, unique_key=r.unique_key, hits=r.hits,
            limit=r.limit, duration=r.duration, algorithm=int(r.algorithm),
            burst=r.burst) for r in reqs]).SerializeToString()
        torch.cuda.synchronize()
        starts = [(clone_table(d.service.backend.table),
                   clone_sketch(d.service.sketch_backend.state))
                  for d in (d0, d1, d2)]
        recs = [DispatchRecorder(d.service.backend, d.service.sketch_backend,
                                 state) for d in (d0, d1, d2)]
        serve_kernel.launches = cms_kernel.launches = 0
        raw = c.run(send_sequential(d0.grpc_address, [payload]),
                    timeout=300)[0]
        require_launches("phase 13 (checks on moved keys)", k2=False)
        err = 0.0
        for rec, (t, sk) in zip(recs, starts):
            rec.close()
            err = max(err, rec.replay(dev, t, sk))
        got = [(r.status, r.limit, r.remaining, r.reset_time, r.error)
               for r in pb.GetRateLimitsResp.FromString(raw).responses]
        want = [None] * len(reqs)
        clock = Clock()
        clock.freeze(T0_NS)
        for i in (0, 1):
            sel = [j for j, u in enumerate(pick.tolist()) if owner[u] == i]
            if not sel:
                continue
            cpu = TorchBackend(DeviceConfig(
                num_slots=DAEMON_SLOTS, ways=WAYS, batch_size=BATCH,
                platform="cpu"), clock=clock)
            cpu._install_table(pre[i])
            for j, r in zip(sel, cpu.check([reqs[j] for j in sel])):
                want[j] = (int(r.status), r.limit, r.remaining, r.reset_time,
                           r.error)
            del cpu
        if got != want:
            diff = sum(a != b for a, b in zip(got, want))
            raise AssertionError(f"{diff} of {len(reqs)} checks on moved "
                                 "keys differ from the plain step on the "
                                 "old owner's pre-remap rows")
        require_planes_inactive("phase 13 (reshard)", c.daemons)
        end = state.counts()
        STATE_PATHS["reshard"] = {k: end[k] - at_start[k] for k in STATE_OPS}
        log(f"phase 13: {RESHARD_CHECKS} checks on moved keys through node "
            f"0 after cutover answer as the plain step on CPU copies of the "
            f"old owners' pre-remap rows; {sum(len(r.k1) for r in recs)} K1 "
            f"dispatches replayed bit-exact")
    finally:
        c.stop()
    state.replay("phase 13 (reshard)")
    return err


# -- phase 14: the hot-key and lease planes at full width ---------------------
PLANES_WARM = 1_000_000      # live keys warmed into each node (not 10M)
LEASE_CLIENTS = 64           # LeasedClients of the steady-state run
LEASE_WORKERS = 4            # their processes, each client after the other
LEASE_KEYS = 1000            # token keys of each client's own
LEASE_ROUNDS = 20            # checks a key
BOUND_LIMIT = 100
HOT_LIMIT = 200
PART_LIMIT = 400
PLANES_TIMEOUT_S = 60.0      # each wait of the phase
# The peer deadlines of phase 14's cluster (forwards, lease proxies, GLOBAL
# hit flushes), raised from the rig's 2 s: after phases 10-13 one of the
# three in-process daemons has stalled past 2 s in 14b, and a forward that
# times out may or may not have applied its hits, which 14b's exact ledger
# cannot allow (PERF.md §6, PR 6).
PLANES_PEER_DEADLINE_S = 30.0
# The cluster's leases: the over-admission fixture of tests/test_lease.py
# (2 holders, a quarter of the limit each, grants that outlive the phase).
BOUND_LEASE = dict(fraction=0.25, max_holders=2, ttl_ms=60_000,
                   reconcile_ms=60_000, low_water=0.0)
# The hot-key windows of tests/test_hotkey.py's cluster (0.3 s), so that a
# promotion and a collapse each take a few seconds.
HOT_CFG = dict(threshold=50.0, mirrors=1, fraction=0.25, window_s=0.3,
               promote_windows=2, demote_windows=2, pressure_ttl_s=1.5)


def admitted(resp) -> bool:
    from gubernator_tpu_torch.core.types import Status

    return resp.error == "" and resp.status == Status.UNDER_LIMIT


def wait_for(cond, what, phase="phase 14"):
    deadline = time.monotonic() + PLANES_TIMEOUT_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{phase}: timed out waiting for {what}")
        time.sleep(0.02)


def wall_clock() -> None:
    """Freeze the daemons' clock at the wall time: a LeasedClient judges a
    grant's expiry by time.time(), the owner stamps it by the service
    clock."""
    from gubernator_tpu_torch.core import clock as clock_mod

    clock_mod.freeze(time.time_ns())


def has_grant(lc) -> bool:
    return any(v.allowance_left > 0 for v in lc.table._leases.values())


def planes_lease_bound(c, smi) -> None:
    """14a: two LeasedClients and a V1Client saturate one key through node
    0 with reconcile quiesced: exactly limit x (1 + 2 x 0.25) admitted."""
    from gubernator_tpu_torch.client import LeasedClient, V1Client
    from gubernator_tpu_torch.core.config import LeaseConfig
    from gubernator_tpu_torch.core.types import RateLimitReq, Status
    from gubernator_tpu_torch.runtime.lease import LEASE_SUFFIX

    wall_clock()
    addr = c.daemons[0].grpc_address
    cfg = LeaseConfig(**BOUND_LEASE)
    req = RateLimitReq(name="lease", unique_key="bound", hits=1,
                       limit=BOUND_LIMIT, duration=60_000)
    holders = [LeasedClient(addr, lease=cfg, client_id=f"bound{i}")
               for i in range(BOUND_LEASE["max_holders"])]
    direct = V1Client(addr)
    try:
        n = sum(admitted(lc.get_rate_limits([req])[0]) for lc in holders)
        wait_for(lambda: all(map(has_grant, holders)), "the two grants")
        allowance = int(BOUND_LIMIT * BOUND_LEASE["fraction"])
        for lc in holders:
            n += sum(admitted(lc.get_rate_limits([req])[0])
                     for _ in range(allowance + 10))
        n += sum(map(admitted, direct.get_rate_limits(
            [req] * (BOUND_LIMIT + 20), timeout=120)))
        bound = int(BOUND_LIMIT * (1 + BOUND_LEASE["max_holders"]
                                   * BOUND_LEASE["fraction"]))
        after = [cl.get_rate_limits([req])[0] for cl in [direct] + holders]
        owner = c.owner_daemon_of(req.hash_key())
        be = owner.service.backend
        row = be.get_cache_item(req.hash_key())
        slot = be.get_cache_item(req.hash_key() + LEASE_SUFFIX)
        if (n != bound or any(r.status != Status.OVER_LIMIT for r in after)
                or int(row.remaining) != 0 or int(slot.remaining) != 0
                or slot.limit != 2 * allowance):
            raise AssertionError(
                f"14a: admitted {n} of bound {bound}; after: "
                f"{[(r.status, r.error) for r in after]}; row remaining "
                f"{row.remaining}, carve slot {slot.limit}/{slot.remaining}")
    finally:
        for lc in holders:
            lc.close()
        direct.close()
    log(f"phase 14a ({smi}): 2 LeasedClients + 1 V1Client on one key of "
        f"limit {BOUND_LIMIT} through node 0: admitted exactly {n} = "
        f"{BOUND_LIMIT} x (1 + 2 x 0.25); every path then OVER_LIMIT; the "
        f"owner's row and its .lease-grant slot (limit {slot.limit}) both "
        f"at remaining 0")


def lease_client_worker(addrs, first, count, keys_n, rounds, limit):
    """One client process of 14b: LeasedClients `first`.. `first+count-1`
    (default client settings), client j on daemon j % len(addrs), each
    over keys_n token keys of its own, one after another.  A client's
    first call (one check a key) falls back and asks for the grants; once
    it holds all of them, its other rounds are timed; then it closes (the
    release reconcile).  Returns the timed seconds, the clients' stats,
    the Lease RPC latencies and the checks that were not admitted."""
    import threading

    from gubernator_tpu_torch.client import LeasedClient
    from gubernator_tpu_torch.core.config import LeaseConfig
    from gubernator_tpu_torch.core.types import RateLimitReq

    lat, bad, lock = [], [], threading.Lock()

    def timed(rpc):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return rpc(*a, **k)
            finally:
                with lock:
                    lat.append(time.perf_counter() - t)
        return call

    def check(lc, keys):
        for r in lc.get_rate_limits(keys, timeout=120):
            if not admitted(r):
                bad.append((int(r.status), r.error, dict(r.metadata or {})))

    stats, burn_s = [], 0.0
    for j in range(first, first + count):
        lc = LeasedClient(addrs[j % len(addrs)], lease=LeaseConfig(),
                          client_id=f"steady{j}")
        lc._peers.Lease = timed(lc._peers.Lease)
        keys = [RateLimitReq(name="steady", unique_key=f"c{j}k{i}", hits=1,
                             limit=limit, duration=600_000)
                for i in range(keys_n)]
        check(lc, keys)
        deadline = time.monotonic() + 60
        while len(lc.table._leases) < keys_n and time.monotonic() < deadline:
            time.sleep(0.005)
        t = time.perf_counter()
        for _ in range(rounds - 1):
            check(lc, keys)
        burn_s += time.perf_counter() - t
        stats.append(lc.stats())
        lc.close()
    return {"burn_s": burn_s, "stats": stats, "lat": lat, "bad": len(bad),
            "first_bad": bad[:2]}


def planes_lease_steady(c, smi) -> None:
    """14b: LEASE_CLIENTS LeasedClients in LEASE_WORKERS processes of their
    own, as a deployment's clients are; then every owner row holds every
    hit.  The three daemons share one interpreter, which serves about as
    many checks a second as one daemon: 64 clients' first calls and
    reconciles all at once overran its peer deadlines (PERF.md §6, PR 6),
    so 4 processes each run their clients one after another."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from gubernator_tpu_torch.ops.kernels import serve_kernel

    wall_clock()
    limit = 1_000_000
    addrs = c.addresses()
    per = LEASE_CLIENTS // LEASE_WORKERS
    k1_0 = serve_kernel.launches
    with ProcessPoolExecutor(
            LEASE_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = [ex.submit(lease_client_worker, addrs, w * per, per,
                          LEASE_KEYS, LEASE_ROUNDS, limit)
                for w in range(LEASE_WORKERS)]
        res = [f.result(timeout=600) for f in futs]
    k1 = serve_kernel.launches - k1_0
    nbad = sum(r["bad"] for r in res)
    if nbad:
        raise AssertionError(f"14b: {nbad} checks not admitted, e.g. "
                             f"{[b for r in res for b in r['first_bad']][:2]}")
    stats = [s for r in res for s in r["stats"]]
    lat = [x for r in res for x in r["lat"]]
    # The processes burn at once, each client after the other: the
    # steady-state rate is the sum of the processes' rates.
    per_proc = (LEASE_ROUNDS - 1) * LEASE_KEYS * per
    rate = sum(per_proc / r["burn_s"] for r in res)
    checks = sum(s["checks"] for s in stats)
    rpcs = {f: sum(s[f] for s in stats)
            for f in ("check_rpcs", "lease_rpcs", "reconcile_rpcs", "rpcs")}
    local = sum(s["local_admitted"] for s in stats)
    p50, p99, _ = percentiles_ms(lat)
    # Every hit lands on its owner's row: checks that fell back at once,
    # burned hits through the reconciles (the last at close).
    by_owner = {}
    for j in range(per * LEASE_WORKERS):
        for i in range(LEASE_KEYS):
            k = f"steady_c{j}k{i}"
            by_owner.setdefault(c.owner_daemon_of(k), []).append(k)
    want = limit - LEASE_ROUNDS

    def settled():
        for d, ks in by_owner.items():
            items = d.service.backend.read_items_bulk(ks)
            if len(items) != len(ks) or any(
                    int(it.remaining) != want for it in items.values()):
                return False
        return True

    t1 = time.perf_counter()
    wait_for(settled, "every owner row to hold every hit")
    probe = "steady_c0k0"
    item = c.owner_daemon_of(probe).service.backend.get_cache_item(probe)
    if int(item.remaining) != want:
        raise AssertionError(f"14b: {probe} remaining {item.remaining}")
    log(f"phase 14b ({smi}): {len(stats)} LeasedClients in {LEASE_WORKERS} "
        f"processes x {LEASE_KEYS} keys x {LEASE_ROUNDS} checks over 3 "
        f"nodes: {checks} checks; once a client held its grants its other "
        f"{LEASE_ROUNDS - 1} rounds ran at {rate:.1f} checks/s summed over "
        f"the processes (host clock); {local} burned locally; RPCs "
        f"{rpcs['rpcs']} = {rpcs['rpcs'] / checks * 1000:.4f} per 1000 "
        f"checks (GetRateLimits fallbacks {rpcs['check_rpcs']}, Lease "
        f"{rpcs['lease_rpcs']}, Reconcile {rpcs['reconcile_rpcs']}; one "
        f"release Reconcile a client at close besides); Lease RPC p50 "
        f"{p50:.3f} ms, p99 {p99:.3f} ms over {len(lat)} calls; K1 launches "
        f"{k1}; all {sum(map(len, by_owner.values()))} owner rows hold "
        f"{LEASE_ROUNDS} hits each (read_items_bulk, and get_cache_item of "
        f"{probe}) {time.perf_counter() - t1:.3f} s after the last close")


def mirror_census(be, fp) -> int:
    """Live .hot-mirror slots among [fp], by the device census."""
    from gubernator_tpu_torch.ops.state import SHADOW_PLANES

    grid = np.zeros((len(SHADOW_PLANES), 8), dtype=np.int64)
    grid[SHADOW_PLANES.index(".hot-mirror"), 0] = fp
    return int(np.asarray(be.table_stats_dispatch(grid)().shadow_slots)
               [0][SHADOW_PLANES.index(".hot-mirror")])


def planes_hot_key(c, smi) -> None:
    """14c: the owner's row saturated, then its SLO target lowered on
    purpose: node 0, the key's first next-arc mirror, promotes the key and
    serves it on the compiled lane's serve_mirror split; the cluster admits
    exactly limit x (1 + mirrors x fraction); restoring the target
    collapses the widening."""
    from gubernator_tpu_torch.client import V1Client
    from gubernator_tpu_torch.core.hashing import bulk_key_hash64
    from gubernator_tpu_torch.core.types import RateLimitReq
    from gubernator_tpu_torch.runtime.hotkey import MIRROR_SUFFIX

    wall_clock()
    d0 = c.daemons[0]
    key = next(f"h{i}" for i in range(10_000) if (lambda cand: (
        not cand[0].info().is_owner and cand[1].info().is_owner))(
            d0.service.local_picker.get_n(f"hot_h{i}", 2)))
    req = RateLimitReq(name="hot", unique_key=key, hits=1, limit=HOT_LIMIT,
                       duration=600_000)
    owner = c.owner_daemon_of(req.hash_key())
    mirror_key = req.hash_key() + MIRROR_SUFFIX
    mirror_fp = int(bulk_key_hash64([mirror_key])[0])
    be0, fp0, svc0 = d0.service.backend, d0.fastpath, d0.service
    window = HOT_CFG["window_s"]
    fraction = HOT_CFG["fraction"]
    direct, cl = V1Client(owner.grpc_address), V1Client(d0.grpc_address)
    try:
        n = sum(map(admitted, direct.get_rate_limits(
            [req] * (HOT_LIMIT + 20), timeout=120)))
        if n != HOT_LIMIT or svc0.mirror_served:
            raise AssertionError(f"14c: {n} admitted before pressure, "
                                 f"{svc0.mirror_served} mirror serves")
        served, fallbacks = fp0.served, fp0.fallbacks
        owner.flightrec.slo_p99_ms = 1e-4  # every RPC breaches: pressure
        t0 = time.monotonic()
        promoted_at, mirrored = None, 0
        while mirrored <= int(HOT_LIMIT * fraction):
            for r in cl.get_rate_limits([req] * 50, timeout=120):
                n += admitted(r)
                mirrored += (r.metadata or {}).get("hotkey") == "mirror"
            if promoted_at is None and svc0.hotkeys.promotions:
                promoted_at = time.monotonic()
            if time.monotonic() - t0 > PLANES_TIMEOUT_S:
                raise AssertionError(f"14c: {mirrored} mirror answers "
                                     f"after {PLANES_TIMEOUT_S} s")
        bound = int(HOT_LIMIT * (1 + HOT_CFG["mirrors"] * fraction))
        slot = be0.get_cache_item(mirror_key)
        census = mirror_census(be0, mirror_fp)
        lane = fp0.served - served
        if (n != bound or slot is None
                or slot.limit != int(HOT_LIMIT * fraction)
                or int(slot.remaining) != 0 or census != 1
                or fp0.fallbacks != fallbacks or lane == 0
                or svc0.mirror_served < mirrored):
            raise AssertionError(
                f"14c: admitted {n} of bound {bound}; mirror slot "
                f"{slot and (slot.limit, slot.remaining)}, census {census}; "
                f"lane served {lane}, fallbacks "
                f"{fp0.fallbacks - fallbacks}, mirror_served "
                f"{svc0.mirror_served} of {mirrored} mirror answers")
        owner.flightrec.slo_p99_ms = 1e9
        t1 = time.monotonic()
        probe = RateLimitReq(name="probe", unique_key="p", hits=1,
                             limit=HOT_LIMIT, duration=600_000)

        def collapsed():
            cl.get_rate_limits([probe], timeout=60)  # windows keep rolling
            return (not svc0.hotkeys.hot_set
                    and be0.get_cache_item(mirror_key) is None)

        wait_for(collapsed, "the hot key to collapse")
        collapse_s = time.monotonic() - t1
        census_after = mirror_census(be0, mirror_fp)
        if census_after or not svc0.hotkeys.demotions:
            raise AssertionError(f"14c: census .hot-mirror {census_after}, "
                                 f"demotions {svc0.hotkeys.demotions}")
    finally:
        owner.flightrec.slo_p99_ms = 1e9
        direct.close()
        cl.close()
    log(f"phase 14c ({smi}): hot key {req.hash_key()} (limit {HOT_LIMIT}) "
        f"owned by node {c.daemons.index(owner)}, node 0 its first next-arc "
        f"mirror; the owner's SLO target lowered on purpose to 1e-4 ms (1e9 "
        f"on every node otherwise, so nothing breaches organically): promoted "
        f"{(promoted_at - t0) / window:.1f} windows of {window} s after, "
        f"{mirrored} mirror answers on node 0's compiled lane ({lane} RPCs "
        f"served, 0 fallbacks, mirror_served {svc0.mirror_served}); admitted "
        f"exactly {n} = {HOT_LIMIT} x (1 + 1 x {fraction}), the mirror slot "
        f"limit {int(HOT_LIMIT * fraction)}; target restored: collapsed "
        f"{collapse_s / window:.1f} windows after (demotions "
        f"{svc0.hotkeys.demotions}), the .hot-mirror slot reset, census "
        f".hot-mirror 1 -> 0")


def planes_partition(c, inj, smi) -> None:
    """14d: a holder on node 0 with a live grant; a seeded chaos partition
    between node 0 and the key's owner; the holder burns its allowance
    locally and the owner serves its own clients; admission stays within
    the closed-form bound; after the heal the burned hits reconcile once."""
    from gubernator_tpu_torch.client import LeasedClient, V1Client
    from gubernator_tpu_torch.core import clock as clock_mod
    from gubernator_tpu_torch.core.config import LeaseConfig
    from gubernator_tpu_torch.core.types import RateLimitReq
    from gubernator_tpu_torch.runtime.lease import LEASE_SUFFIX

    wall_clock()
    d0 = c.daemons[0]
    key = next(f"p{i}" for i in range(10_000)
               if not d0.service.get_peer(f"part_p{i}").info().is_owner)
    req = RateLimitReq(name="part", unique_key=key, hits=1,
                       limit=PART_LIMIT, duration=600_000)
    owner = c.owner_daemon_of(req.hash_key())
    be = owner.service.backend
    allowance = int(PART_LIMIT * BOUND_LEASE["fraction"])
    direct_n = PART_LIMIT // 4
    lc = LeasedClient(d0.grpc_address, lease=LeaseConfig(
        **dict(BOUND_LEASE, reconcile_ms=500)), client_id="part")
    direct = V1Client(owner.grpc_address)

    def used():
        it = be.get_cache_item(req.hash_key())
        return PART_LIMIT - int(it.remaining)

    try:
        n = admitted(lc.get_rate_limits([req])[0])  # the fallback forward
        wait_for(lambda: has_grant(lc), "the grant")
        inj.partition({owner.grpc_address}, {d0.grpc_address})
        burned = 0
        for _ in range(allowance + 3):
            r = lc.get_rate_limits([req], timeout=60)[0]
            n += admitted(r)
            burned += admitted(r) and (r.metadata or {}).get(
                "lease") == "local"
        n += sum(map(admitted, direct.get_rate_limits([req] * direct_n,
                                                      timeout=120)))
        time.sleep(1.5)  # reconciles and flush windows meet the partition
        during = used()
        cut = inj.injected.get("partition", 0)
        bound = int(PART_LIMIT * (1 + BOUND_LEASE["max_holders"]
                                  * BOUND_LEASE["fraction"]))
        if (n > bound or burned != allowance or during != 1 + direct_n
                or not cut):
            raise AssertionError(
                f"14d: admitted {n} (bound {bound}), burned {burned} of "
                f"{allowance}, owner row used {during}, partitioned calls "
                f"{cut}")
        inj.heal()
        total = 1 + direct_n + burned
        wait_for(lambda: used() == total, "the burned hits to reconcile")
        time.sleep(1.0)  # more flush windows: nothing applies twice
        if used() != total:
            raise AssertionError(f"14d: owner row used {used()}, not {total}")
        # Expiry on the owner's clock: past the TTL the sweep revokes the
        # holder and drops its carve slot.
        clock_mod.freeze(clock_mod.default_clock().now_ns()
                         + (BOUND_LEASE["ttl_ms"] + 1_000) * 1_000_000)
        swept = c.run(owner.service.leases.sweep_apply())
        if swept < 1 or be.get_cache_item(
                req.hash_key() + LEASE_SUFFIX) is not None:
            raise AssertionError(f"14d: sweep dropped {swept} slots")
    finally:
        lc.close()
        direct.close()
    log(f"phase 14d ({smi}): seeded chaos partition of node 0 from the owner "
        f"of {req.hash_key()} (limit {PART_LIMIT}), {cut} peer calls cut: "
        f"the holder burned its allowance {burned} locally, the owner "
        f"admitted {direct_n} to its own client; admitted {n} <= the bound "
        f"{bound}; the owner row held {during} used until the heal, then "
        f"{total} = 1 + {direct_n} + {burned} (the burned hits once); the "
        f"grant expired on the owner's clock and the sweep dropped its slot")


def phase_planes(dev, smi, state) -> float:
    """Phase 14: the hot-key and lease planes on a 3-node cluster at full
    width, every K1 dispatch replayed through the plain version."""
    import shutil
    import tempfile

    import torch

    from gubernator_tpu_torch.core import clock as clock_mod
    from gubernator_tpu_torch.core.config import HotKeyConfig, LeaseConfig
    from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel
    from gubernator_tpu_torch.ops.sketch import clone_sketch
    from gubernator_tpu_torch.ops.state import clone_table
    from gubernator_tpu_torch.testing.chaos import ChaosInjector, ChaosPlan

    t_phase = time.perf_counter()
    wall_clock()
    inj = ChaosInjector(ChaosPlan(seed=SEED + 1400))
    dumps = tempfile.mkdtemp(prefix="gubernator-flightrec-")
    c = start_daemons(dev, 3, DAEMON_SLOTS, "pipelined", flightrec=True,
                      flightrec_dir=dumps, lease=LeaseConfig(**BOUND_LEASE),
                      hotkey=HotKeyConfig(**HOT_CFG), chaos=inj)
    recs = []
    try:
        for d in c.daemons:
            # The card's host may breach the production 2 ms target on its
            # own; 14c pressures one owner on purpose instead.
            d.flightrec.slo_p99_ms = 1e9
            d.flightrec.window_s = 2.0
            # Every PeerClient reads the service's BehaviorConfig per call.
            d.service.cfg.behaviors.batch_timeout_s = PLANES_PEER_DEADLINE_S
            d.service.global_mgr.timeout_s = PLANES_PEER_DEADLINE_S
        for i, d in enumerate(c.daemons):
            phase_warm(d.service.backend, dev, f"phase 14 (node {i})",
                       keys=PLANES_WARM)
        torch.cuda.synchronize()
        starts = [(clone_table(d.service.backend.table),
                   clone_sketch(d.service.sketch_backend.state))
                  for d in c.daemons]
        recs = [DispatchRecorder(d.service.backend, d.service.sketch_backend,
                                 state) for d in c.daemons]
        serve_kernel.launches = cms_kernel.launches = 0
        planes_lease_bound(c, smi)
        planes_lease_steady(c, smi)
        planes_hot_key(c, smi)
        planes_partition(c, inj, smi)
        require_launches("phase 14 (hot-key and lease planes)", k2=False)
        # Stop the daemons before the replay, their recorders still on: a
        # lease sweep or a late reconcile may still dispatch after 14d
        # (the clock moved past every grant's TTL), and the replay must
        # see every dispatch and run while none is launched.
        c.stop()
        c = None
        done, recs = recs, []
        for rec in done:
            rec.close()
        t0 = time.perf_counter()
        err = max(rec.replay(dev, t, sk) for rec, (t, sk) in zip(done,
                                                                  starts))
        log(f"phase 14: {sum(len(r.k1) for r in done)} K1 dispatches of the "
            f"three nodes (lease carves, mirror admissions and resets, "
            f"reconciles, forwards) replayed through the plain version in "
            f"{time.perf_counter() - t0:.3f} s: responses, tables, claim "
            f"words bit-exact; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
            f"{time.perf_counter() - t_phase:.1f} s")
        return err
    finally:
        if c is not None:
            c.stop()
        for rec in recs:
            rec.close()
        clock_mod.freeze(T0_NS)
        shutil.rmtree(dumps, ignore_errors=True)


# -- phase 15: regions, gossip discovery and the load generator ---------------
REGION_DCS = ("east", "east", "west", "west")
REGION_KEYS = 1024           # west-homed keys checked from east (15b)
REGION_CHECKS = 35           # checks a key
REGION_LIMIT = 100
REGION_FRACTION = 0.25       # a remote region's carve: 25 of 100
REGION_BATCH = 1000          # requests a GetRateLimits (the wire's maximum)
# One batch of arrivals every 0.8 s: 1,250 checks/s offered, below what the
# four in-process daemons served on the card's host when offered 2,500/s
# (2,374.1 and 2,016.7 checks/s, PERF.md §6, PR 7), so that 15b's p50/p99
# time a carve call's serve and not an open loop's backlog.
REGION_GROUP_S = 0.8
REGION_RECONCILE_MS = 200
REGION_DURATION_MS = 600_000  # outlives the phase: one window a key
REGION_BG_KEYS = 8192        # east-homed keys of the background load
REGION_BG_BATCH = 500        # its requests a call, a call every REGION_GROUP_S
PART_KEYS = 256              # west-homed keys checked during 15c's partition
REGION_WARM = PLANES_WARM    # live keys warmed into each node


def gossip_ports(n):
    """n free gRPC ports whose gossip ports (+ 1000, the daemon's default)
    are free too."""
    import socket

    out = []
    while len(out) < n:
        s, g = socket.socket(), socket.socket(socket.AF_INET,
                                              socket.SOCK_DGRAM)
        try:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            if port + 1000 <= 65535 and port not in out:
                g.bind(("127.0.0.1", port + 1000))
                out.append(port)
        except OSError:
            pass
        finally:
            s.close()
            g.close()
    return out


def region_boot(dev, inj):
    """15a: four daemons, two a region, at full width; they find each other
    by gossip on 127.0.0.1 seeded with the first node's gossip port, and no
    static peer list.  Returns (cluster, seconds to converge)."""
    from dataclasses import replace

    from gubernator_tpu_torch.core.config import (
        CircuitConfig,
        DaemonConfig,
        DeviceConfig,
        RegionConfig,
        SketchTierConfig,
    )
    from gubernator_tpu_torch.testing.cluster import Cluster

    ports = gossip_ports(len(REGION_DCS))
    seed = f"127.0.0.1:{ports[0] + 1000}"
    base = DaemonConfig(
        serve_mode="pipelined", chaos=inj, peer_discovery_type="gossip",
        sketch=SketchTierConfig(names=["cms"], depth=SKETCH_DEPTH,
                                width=SKETCH_WIDTH,
                                window_ms=SKETCH_WINDOW_MS,
                                batch_size=SKETCH_BATCH),
        region=RegionConfig(enabled=True, fraction=REGION_FRACTION,
                            reconcile_ms=REGION_RECONCILE_MS,
                            drift_max=100_000),
        # The region_failover scenario's breaker schedule, so that the WAN
        # arcs re-close within seconds of 15c's heal.
        circuit=CircuitConfig(failure_threshold=3, base_backoff_s=0.1,
                              max_backoff_s=1.0, jitter=0.2))
    device = DeviceConfig(num_slots=DAEMON_SLOTS, ways=WAYS,
                          batch_size=BATCH, platform=dev.type)
    c = Cluster()
    t0 = time.perf_counter()
    for i, (dc, p) in enumerate(zip(REGION_DCS, ports)):
        addr = f"127.0.0.1:{p}"
        d = c.boot(device, replace(
            base, advertise_address=addr,
            gossip_bind_address=f"127.0.0.1:{p + 1000}",
            gossip_seeds=[] if i == 0 else [seed]),
            data_center=dc, grpc_address=addr)
        c.daemons.append(d)
    t_booted = time.perf_counter()

    def converged():
        for d in c.daemons:
            s = d.service
            held = s.local_picker.size() + sum(
                pk.size() for pk in s.region_picker.pickers().values())
            if held != len(REGION_DCS) or set(s.regions.universe()) != {
                    "east", "west"}:
                return False
        return True

    try:
        wait_for(converged, "gossip convergence", "phase 15")
    except BaseException:
        c.stop()
        raise
    t_conv = time.perf_counter()
    return c, t_conv - t0, t_conv - t_booted


def region_nodes(c):
    east = [d for d in c.daemons if d.conf.data_center == "east"]
    west = [d for d in c.daemons if d.conf.data_center == "west"]
    return east, west


def homed_keys(rm, region, name, n):
    out, i = [], 0
    while len(out) < n:
        k = f"k{i}"
        if rm.home_region(f"{name}_{k}") == region:
            out.append(k)
        i += 1
    return out


def home_used(c, name, keys):
    """limit - remaining of each key's row at its home-region owner (None
    where the owner holds no row)."""
    by_addr = {d.grpc_address: d for d in c.daemons}
    _, west = region_nodes(c)
    out = []
    for k in keys:
        hk = f"{name}_{k}"
        owner = by_addr[west[0].service.get_peer(hk).info().grpc_address]
        it = owner.service.backend.get_cache_item(hk)
        out.append(None if it is None else REGION_LIMIT - int(it.remaining))
    return out


def reconciled(east):
    return all(d.service.regions.drift_hits == 0 for d in east)


def region_counters(c):
    out = {"drift": 0, "dropped": 0, "rehomes": 0, "degraded": 0,
           "sends": 0, "carve_served": 0}
    for d in c.daemons:
        rm = d.service.regions
        out["drift"] += rm.drift_hits
        out["dropped"] += rm.reconcile_dropped
        out["rehomes"] += rm.rehomes
        out["sends"] += rm.reconcile_sends
        out["carve_served"] += rm.carve_served
        out["degraded"] += int(d.metrics.region_degraded._value.get())
    return out


class LagTee:
    """Forwards reconcile-lag samples to the daemon's histogram and keeps
    them (the lag from a burn's queueing to its delivery home)."""

    def __init__(self, hist, into):
        self.hist, self.into = hist, into

    def observe(self, v):
        self.into.append(v)
        self.hist.observe(v)


def region_carve_load(c, smi, lags):
    """15b: the port's load generator, through its own runner and report,
    checks REGION_KEYS west-homed keys from east REGION_CHECKS times each
    in batches of REGION_BATCH, while a background load checks east-homed
    keys at home; every key admits exactly its carve, every home row then
    holds exactly the carve, nothing drifts and nothing drops."""
    import asyncio
    from dataclasses import dataclass
    from typing import Tuple

    from gubernator_tpu_torch.client import AsyncV1Client
    from gubernator_tpu_torch.core.config import LoadConfig
    from gubernator_tpu_torch.core.types import RateLimitReq
    from gubernator_tpu_torch.loadgen import (
        SCENARIOS,
        PhaseSpec,
        ScenarioSpec,
        run_scenario,
    )

    east, west = region_nodes(c)
    rm = east[0].service.regions
    keys = homed_keys(rm, "west", "p15b", REGION_KEYS)
    bg_keys = homed_keys(rm, "east", "p15bg", REGION_BG_KEYS)
    carve = int(REGION_LIMIT * REGION_FRACTION)
    bg = {"calls": 0, "errors": 0, "carved": 0}

    async def background(ctx):
        """Home-region load: batches of east-homed keys to the east nodes
        until the verdict stops it."""
        stop = asyncio.Event()
        cls = [AsyncV1Client(d.grpc_address) for d in east]

        async def load():
            rng = np.random.default_rng(SEED + 1500)
            try:
                while not stop.is_set():
                    pick = rng.integers(0, len(bg_keys), REGION_BG_BATCH)
                    rs = await cls[bg["calls"] % len(cls)].get_rate_limits([
                        RateLimitReq(name="p15bg", unique_key=bg_keys[j],
                                     hits=1, limit=1_000_000,
                                     duration=REGION_DURATION_MS)
                        for j in pick], timeout=60.0)
                    bg["calls"] += 1
                    bg["errors"] += sum(r.error != "" for r in rs)
                    bg["carved"] += sum("region_serve" in (r.metadata or {})
                                        for r in rs)
                    await asyncio.sleep(REGION_GROUP_S)
            finally:
                for cl in cls:
                    await cl.close()

        ctx.state["bg_stop"] = stop
        ctx.state["bg_task"] = asyncio.ensure_future(load())

    async def stop_background(ctx):
        ctx.state["bg_stop"].set()
        await ctx.state["bg_task"]

    def verdict(ctx):
        t_end = time.perf_counter()  # the runner's last answer is in
        ctx.cluster.run(stop_background(ctx), timeout=120.0)
        totals = ctx.totals()
        n = REGION_KEYS * REGION_CHECKS
        per_key = totals.per_key_admitted
        if (totals.errors or totals.admitted + totals.denied != n
                or sorted(per_key) != list(range(REGION_KEYS))
                or set(per_key.values()) != {carve}):
            raise AssertionError(
                f"15b: errors {totals.errors}, admitted {totals.admitted}, "
                f"denied {totals.denied}, keys admitted "
                f"{len(per_key)} of {REGION_KEYS}, per-key admissions "
                f"{sorted(set(per_key.values()))}; failed checks said "
                f"{totals.error_kinds.most_common(3)}")
        if bg["errors"] or bg["carved"] or not bg["calls"]:
            raise AssertionError(f"15b: background load {bg}")
        wait_for(lambda: reconciled(east), "15b's reconcile", "phase 15")
        drain_s = time.perf_counter() - t_end
        used = home_used(ctx.cluster, "p15b", keys)
        got = region_counters(ctx.cluster)
        if set(used) != {carve} or got["drift"] or got["dropped"]:
            raise AssertionError(
                f"15b: home rows used {sorted(set(map(str, used)))}, "
                f"counters {got}")
        return {"admitted": totals.admitted, "denied": totals.denied,
                "keys": REGION_KEYS, "carve": carve,
                "drift_hits": got["drift"],
                "reconcile_dropped": got["dropped"],
                "reconcile_sends": got["sends"],
                "background_calls": bg["calls"],
                "drain_s": round(drain_s, 3)}

    @dataclass(frozen=True)
    class RegionScenario(ScenarioSpec):
        keys: Tuple[str, ...] = ()

        def key_name(self, idx: int) -> str:
            return self.keys[idx]

    rps = REGION_BATCH / REGION_GROUP_S
    spec = RegionScenario(
        name="p15b_region_carve",
        description="west-homed keys checked from east, each "
        f"{REGION_CHECKS} times, in batches of {REGION_BATCH}, beside a "
        "home-region background load",
        phases=(PhaseSpec("carve", 1.0, "paced", "cycle", target_rps=rps,
                          params={"group": REGION_BATCH},
                          fault="background"),),
        limit=REGION_LIMIT, window_ms=REGION_DURATION_MS,
        key_universe=REGION_KEYS, tenant="p15b", verdict=verdict,
        hooks={"background": background}, keys=tuple(keys))
    SCENARIOS[spec.name] = spec
    try:
        t0 = time.perf_counter()
        out = run_scenario(
            spec.name,
            LoadConfig(seed=SEED, duration_s=REGION_KEYS * REGION_CHECKS
                       / rps, clients=4, target_rps=rps),
            cluster=c, addresses=[d.grpc_address for d in east],
            batch=REGION_BATCH, timeout=60.0)
        wall = time.perf_counter() - t0
    finally:
        SCENARIOS.pop(spec.name, None)
    art = out["artifact"]
    row = next(r for r in art["results"] if r["phase"] == "carve")
    if art["platform"] != "cuda" or row["platform"] != "cuda":
        raise AssertionError(f"15b: the report says {art['platform']!r}")
    v = out["verdict"]
    lag = np.sort(np.asarray(lags)) * 1e3
    log(f"phase 15b ({smi}): the loadgen's runner sent {row['arrivals']} "
        f"checks of {REGION_KEYS} west-homed keys from east in batches of "
        f"{REGION_BATCH} ({REGION_CHECKS} a key, limit {REGION_LIMIT}, "
        f"fraction {REGION_FRACTION}) beside {v['background_calls']} "
        f"background calls of {REGION_BG_BATCH} east-homed keys: every key "
        f"admitted exactly {carve} in east ({v['admitted']} admitted, "
        f"{v['denied']} denied); every west home row then used exactly "
        f"{carve}; drift_hits {v['drift_hits']}, reconcile_dropped "
        f"{v['reconcile_dropped']}, {v['reconcile_sends']} reconcile sends")
    log(f"phase 15b ({smi}): carve serve p50 {row['p50_ms']} ms, p99 "
        f"{row['p99_ms']} ms, p99.9 {row['p999_ms']} ms (open loop, from "
        f"the intended send; send skew p99 {row['send_skew_p99_ms']} ms); "
        f"{row['checks_per_sec']} checks/s over {row['wall_s']} s; "
        f"reconcile lag p50 {float(np.percentile(lag, 50)):.3f} ms, p99 "
        f"{float(np.percentile(lag, 99)):.3f} ms over {len(lag)} burns, "
        f"drift 0 {v['drain_s']} s after the last answer; report platform "
        f"{art['platform']!r}; run {wall:.3f} s")
    return out


def region_partition(c, inj, smi):
    """15c: east partitioned from west by the chaos injector for two
    reconcile windows and more: the carve keeps serving and admits nothing
    past its bound; the provably unsent burns requeue; after the heal they
    apply once and the links rehome."""
    from gubernator_tpu_torch.client import V1Client
    from gubernator_tpu_torch.core.types import RateLimitReq

    east, west = region_nodes(c)
    rm = east[0].service.regions
    keys = homed_keys(rm, "west", "p15c", PART_KEYS)
    carve = int(REGION_LIMIT * REGION_FRACTION)
    before = region_counters(c)
    reqs = [RateLimitReq(name="p15c", unique_key=k, hits=1,
                         limit=REGION_LIMIT, duration=REGION_DURATION_MS)
            for k in keys] * REGION_CHECKS
    clients = [V1Client(d.grpc_address) for d in east]
    inj.partition({d.grpc_address for d in east},
                  {d.grpc_address for d in west})
    try:
        per_key = {k: 0 for k in keys}
        errors = 0
        for i, lo in enumerate(range(0, len(reqs), REGION_BATCH)):
            chunk = reqs[lo:lo + REGION_BATCH]
            for r, rs in zip(chunk, clients[i % 2].get_rate_limits(
                    chunk, timeout=120)):
                errors += rs.error != ""
                per_key[r.unique_key] += admitted(rs)
        wait_for(lambda: all(
            d.service.regions._link("west").state == "degraded"
            for d in east if d.service.regions.drift_hits),
            "the carving nodes' links to degrade", "phase 15")
        time.sleep(2 * REGION_RECONCILE_MS / 1000)  # two more windows
        during = home_used(c, "p15c", keys)
        drift = sum(d.service.regions.drift_hits for d in east)
        cut = inj.injected.get("partition", 0)
        if (errors or set(per_key.values()) != {carve}
                or set(during) != {None} or drift != carve * PART_KEYS
                or not cut):
            raise AssertionError(
                f"15c: errors {errors}, per-key admissions "
                f"{sorted(set(per_key.values()))}, home rows "
                f"{sorted(set(map(str, during)))}, drift {drift}, "
                f"partitioned calls {cut}")
        t_heal = time.perf_counter()
        inj.heal()
        wait_for(lambda: reconciled(east) and all(
            lk.state == "remote" for d in east
            for lk in d.service.regions._links.values()),
            "the heal", "phase 15")
        heal_s = time.perf_counter() - t_heal
        time.sleep(2 * REGION_RECONCILE_MS / 1000)  # nothing applies twice
        after = home_used(c, "p15c", keys)
        got = region_counters(c)
        if set(after) != {carve} or got["dropped"] or got["drift"]:
            raise AssertionError(f"15c: home rows "
                                 f"{sorted(set(map(str, after)))}, "
                                 f"counters {got}")
    finally:
        inj.heal()
        for cl in clients:
            cl.close()
    log(f"phase 15c ({smi}): chaos partition of east from west "
        f"({cut} WAN calls cut): {PART_KEYS} west-homed keys x "
        f"{REGION_CHECKS} checks from east, no error; every key admitted "
        f"exactly {carve}, none past its carve; {drift} burns held as "
        f"drift, no home row touched; degraded "
        f"{got['degraded'] - before['degraded']}, rehomes "
        f"{got['rehomes'] - before['rehomes']}; after the heal every burn "
        f"applied once ({heal_s:.3f} s to drift 0 and every link remote), "
        f"reconcile_dropped {got['dropped']}")


def phase_regions(dev, smi, state) -> float:
    """Phase 15: planet-scale regions over gossip discovery, driven by the
    port's load generator, at full width; every K1 dispatch replayed
    through the plain version."""
    import torch

    from gubernator_tpu_torch.core import clock as clock_mod
    from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel
    from gubernator_tpu_torch.ops.sketch import clone_sketch
    from gubernator_tpu_torch.ops.state import clone_table
    from gubernator_tpu_torch.testing.chaos import ChaosInjector, ChaosPlan

    t_phase = time.perf_counter()
    # Real time: the handoffs of the gossip remaps release on the clock,
    # and every key's window (600 s) outlives the phase.
    clock_mod.unfreeze()
    inj = ChaosInjector(ChaosPlan(seed=SEED + 1500))
    c, conv_s, conv_after_s = region_boot(dev, inj)
    recs = []
    try:
        log(f"phase 15a ({smi}): 4 daemons ({'/'.join(REGION_DCS)}) at "
            f"{DAEMON_SLOTS} slots x {WAYS} ways found each other by gossip "
            f"on 127.0.0.1 from one seed: every picker holds 4 peers and "
            f"every universe is {{east, west}} {conv_s:.3f} s after the "
            f"first boot ({conv_after_s:.3f} s after the last)")
        wait_for(lambda: all(
            d.service.reshard.handoffs_started
            == d.service.reshard.handoffs_completed
            + d.service.reshard.handoffs_aborted for d in c.daemons),
            "the remaps' handoffs", "phase 15")
        lags = []
        for d in c.daemons:
            # Phase 14's peer deadlines (forwards, reconciles): a timed-out
            # reconcile is dropped by design, which 15b's exact ledger
            # cannot absorb.
            d.service.cfg.behaviors.batch_timeout_s = PLANES_PEER_DEADLINE_S
            d.service.global_mgr.timeout_s = PLANES_PEER_DEADLINE_S
            rm = d.service.regions
            rm.timeout_s = PLANES_PEER_DEADLINE_S
            rm.metrics.region_reconcile_lag = LagTee(
                rm.metrics.region_reconcile_lag, lags)
        for i, d in enumerate(c.daemons):
            phase_warm(d.service.backend, dev, f"phase 15 (node {i})",
                       keys=REGION_WARM)
        torch.cuda.synchronize()
        starts = [(clone_table(d.service.backend.table),
                   clone_sketch(d.service.sketch_backend.state))
                  for d in c.daemons]
        recs = [DispatchRecorder(d.service.backend, d.service.sketch_backend,
                                 state) for d in c.daemons]
        at_start = dict(state.launches)
        serve_kernel.launches = cms_kernel.launches = 0
        region_carve_load(c, smi, lags)
        region_partition(c, inj, smi)
        require_launches("phase 15 (regions, gossip, loadgen)", k2=False)
        k1n, k2n = serve_kernel.launches, cms_kernel.launches
        STATE_PATHS["regions"] = {k: state.launches[k] - at_start[k]
                                  for k in STATE_OPS}
        fallbacks = sum(d.fastpath.fallbacks for d in c.daemons
                        if d.fastpath is not None)
        c.stop()  # as in phase 14: every dispatch recorded, none during
        c = None  # the replay
        done, recs = recs, []
        for rec in done:
            rec.close()
        t0 = time.perf_counter()
        err = max(rec.replay(dev, t, sk) for rec, (t, sk) in zip(done,
                                                                  starts))
        log(f"phase 15: {sum(len(r.k1) for r in done)} K1 dispatches of the "
            f"four nodes (carves, forwarded carve checks, home-row "
            f"reconciles, background load, slot drops) replayed through the "
            f"plain version in {time.perf_counter() - t0:.3f} s: responses, "
            f"tables, claim words bit-exact; K1 launches {k1n}, K2 launches "
            f"{k2n}; the compiled lane declined "
            f"{fallbacks} batches (regions take the object path); peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB; phase {time.perf_counter() - t_phase:.1f} s")
        return err
    finally:
        if c is not None:
            c.stop()
        for rec in recs:
            rec.close()
        clock_mod.freeze(T0_NS)


# -- phase 16: the sharded table and the collective GLOBAL engine -------------
MESH_SHARDS = 4              # BASELINE.json configurations 3 and 4
MESH_GLOBAL_CALLS = 64       # 16b: check() calls of GLOBAL requests
MESH_GLOBAL_REQS = 1000
MESH_GLOBAL_KEYS = 4096
MESH_GLOBAL_LIMIT = 1000     # keys pending that trigger a sync
MESH_ZIPF_S = 1.1
MESH_A2A_CALLS = 2           # the a2a window's check() calls
MESH_DAEMON_GLOBAL_KEYS = 1024
MESH_CLIENTS = DAEMON_CLIENTS
MESH_RPCS = 3
MESH_SMALL_CLIENTS = SMALL_CLIENTS
MESH_PATHS = {"serve_kernel": {}, "cms_kernel": {}}  # path -> launches
MESH_TIMES = {}


class MeshRecorder:
    """Keeps, in table order, every per-shard K1 launch of a mesh backend
    and its GlobalEngine (the wrapper `serve_kernel.persistent_serve_step`,
    which parallel/sharded.mesh_ring_step calls once a shard), every
    broadcast upsert of a sync into a cache shard, and every K2 dispatch of
    a sketch backend.  Nothing is copied: each input is a fresh tensor per
    dispatch."""

    def __init__(self, be, eng=None, sb=None):
        from gubernator_tpu_torch.ops.kernels import serve_kernel
        from gubernator_tpu_torch.parallel import global_sync

        self.be, self.eng, self.sb = be, eng, sb
        self.n = be.n
        self.tables = {"auth": be.table}
        if eng is not None:
            self.tables["cache"] = eng.cache_table
        where = {}
        for label, t in self.tables.items():
            L = t.key.shape[0] // self.n
            for s in range(self.n):
                where[t.key.data_ptr() + s * L * t.key.element_size()] = (
                    label, s)
        self.events, self.k2 = [], []
        self._k1, self._bcast = (serve_kernel.persistent_serve_step,
                                 global_sync.store_cached_rows)

        def k1(table, qs, nows, seq, ways=8, claim=None, scratch=None):
            out = self._k1(table, qs, nows, seq, ways, claim=claim,
                           scratch=scratch)
            label, s = where[table.key.data_ptr()]
            self.events.append(("k1", label, s, qs, nows, seq, out[1]))
            return out

        def bcast(table, rows, now, ways=8):
            label, s = where[table.key.data_ptr()]
            self.events.append(("bcast", label, s, rows, now))
            return self._bcast(table, rows, now, ways)

        serve_kernel.persistent_serve_step = k1
        global_sync.store_cached_rows = bcast
        if sb is not None:
            self._dispatch = sb._dispatch

            def dispatch(kh, hc, lc, now):
                packed = self._dispatch(kh, hc, lc, now)
                self.k2.append((kh, hc, lc, now, packed))
                return packed

            sb._dispatch = dispatch

    def close(self):
        from gubernator_tpu_torch.ops.kernels import serve_kernel
        from gubernator_tpu_torch.parallel import global_sync

        serve_kernel.persistent_serve_step = self._k1
        global_sync.store_cached_rows = self._bcast
        if self.sb is not None:
            del self.sb._dispatch

    def k1_launches(self, label=None) -> int:
        return sum(1 for ev in self.events if ev[0] == "k1"
                   and label in (None, ev[1]))

    def replay(self, dev, starts, sketch=None) -> float:
        """Every recorded event again, in order, on copies of the starting
        tables (`starts`: label -> table): each K1 launch through the plain
        ring_step on the same shard's views of the copy, each broadcast
        upsert through the same torch op; the K2 dispatches through the
        plain multi_step on a copy of the sketch.  Requires every output,
        the final tables and sketch and the claim words equal."""
        import torch

        from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel
        from gubernator_tpu_torch.ops.ring import ring_step
        from gubernator_tpu_torch.ops.sketch import multi_step
        from gubernator_tpu_torch.parallel.mesh import shard_view

        before = serve_kernel.launches, cms_kernel.launches
        err = 0.0
        for j, ev in enumerate(self.events):
            view = shard_view(starts[ev[1]], ev[2], self.n)
            if ev[0] == "bcast":
                self._bcast(view, ev[3], ev[4], WAYS)
                continue
            _, _, s, qs, nows, seq, resps = ev
            _, pr, _ = ring_step(view, qs, nows, seq, WAYS)
            if not torch.equal(pr, resps):
                raise AssertionError(f"K1 launch {j} ({ev[1]} shard {s}): "
                                     "responses differ from the plain "
                                     "version's")
            err = max(err, max_abs_err(pr, resps))
        def d(a):
            return torch.as_tensor(a).to(dev)

        for j, (kh, hc, lc, now, packed) in enumerate(self.k2):
            sketch, pp = multi_step(sketch, d(kh), d(hc), d(lc), now)
            if not torch.equal(pp, packed):
                raise AssertionError(f"K2 dispatch {j}: outputs differ "
                                     "from the plain version's")
            err = max(err, max_abs_err(pp, packed))
        torch.cuda.synchronize()
        if (serve_kernel.launches, cms_kernel.launches) != before:
            raise AssertionError("the plain replay launched a kernel")
        for label, live in self.tables.items():
            if not tables_equal(live, starts[label]):
                raise AssertionError(f"the {label} table differs from the "
                                     "plain replay's")
        if self.sb is not None and not sketch_equal(self.sb.state, sketch):
            raise AssertionError("the sketch differs from the plain "
                                 "replay's")
        claims = [self.be.claim] + ([self.eng.cache_claim]
                                    if self.eng is not None else [])
        for claim in claims:
            if claim is not None and not bool(
                    (claim == serve_kernel.INT32_MAX).all()):
                raise AssertionError("claim words not restored")
        return err


def mesh_warm(be, ref, dev, label, keys=None) -> None:
    """Warm a mesh backend to `keys` (WARM_KEYS) live synthetic keys
    through K1, token:leaky 2:1, each fingerprint placed in its own shard's
    lanes (hash bits 32-33 are the shard of a 4-shard mesh); the same
    fingerprints, as rounds of BATCH lanes, go into the single-table
    `ref` when one is given.  The rows are stamped a minute before the
    clock: a full bucket's least recently touched row is then a warm row,
    never a row of the traffic, whichever layout the bucket has (a tie of
    stamps breaks by way index, which differs between the mesh's buckets
    and the single table's)."""
    import torch

    keys = WARM_KEYS if keys is None else keys
    n, k = be.n, 8
    rng = np.random.default_rng(SEED + 1601)
    now = be.clock.millisecond_now() - 60_000
    seq = be.ring_seq_init()
    rseq = ref.ring_seq_init() if ref is not None else None
    fed, launches, t0 = 0, 0, time.perf_counter()
    mask = np.int64(3 << 32)
    while True:
        if fed >= keys and be.occupancy() >= keys and (
                ref is None or ref.occupancy() >= keys):
            break
        h = rng.integers(-(2**63), 2**63 - 1, size=(k, n, BATCH),
                         dtype=np.int64, endpoint=True)
        h = (h & ~mask) | (np.arange(n, dtype=np.int64)[None, :, None] << 32)
        h[h == 0] = 1 << 40
        hd = torch.from_numpy(h).to(dev)
        qs = torch.zeros((k, 12, n, BATCH), dtype=torch.int64, device=dev)
        qs[:, 0] = hd
        qs[:, 1] = 1                                   # hits
        qs[:, 2] = 100                                 # limit
        qs[:, 3] = 3_600_000                           # live through the run
        qs[:, 4] = (hd % 3 == 0).to(torch.int64)       # token:leaky 2:1
        qs[:, 5] = 100                                 # burst
        qs[:, 10] = 1                                  # active
        nows = torch.full((k,), now, dtype=torch.int64, device=dev)
        _, seq = be.ring_step_dispatch(qs, nows, seq)
        if ref is not None:
            rq = qs.permute(0, 2, 1, 3).reshape(k * n, 12, BATCH)
            _, rseq = ref.persistent_serve_dispatch(
                rq.contiguous(), torch.full((k * n,), now, dtype=torch.int64,
                                            device=dev), rseq)
        fed += k * n * BATCH
        launches += 1
        if fed >= keys:
            k = 1
    torch.cuda.synchronize()
    log(f"{label}: fed {fed} fingerprints in {launches} mesh dispatches "
        f"({launches * n} K1 launches) in {time.perf_counter() - t0:.3f} s; "
        f"shard occupancy {be.shard_occupancy()} of {be.local_slots} slots "
        f"each" + (f"; the single table's occupancy {ref.occupancy()}"
                   if ref is not None else ""))


def phase_mesh_library(dev, smi, name, clock):
    """16a: the library mesh at full width against a single-table
    TorchBackend fed the same requests on the same frozen clock, every
    per-shard launch replayed through the plain version, timed.  Returns
    (mesh backend, reference backend, max_abs_err)."""
    import torch

    from gubernator_tpu_torch.core.config import DeviceConfig
    from gubernator_tpu_torch.ops.kernels import serve_kernel
    from gubernator_tpu_torch.ops.ring import ring_step
    from gubernator_tpu_torch.ops.state import clone_table
    from gubernator_tpu_torch.parallel.mesh import claim_view, shard_view
    from gubernator_tpu_torch.parallel.sharded import (
        MeshBackend,
        mesh_ring_step,
    )
    from gubernator_tpu_torch.runtime.backend import TorchBackend

    n = MESH_SHARDS
    be = MeshBackend(DeviceConfig(num_slots=NUM_SLOTS, ways=WAYS,
                                  batch_size=BATCH, num_shards=n,
                                  platform=dev.type), clock=clock)
    ref = TorchBackend(DeviceConfig(num_slots=NUM_SLOTS, ways=WAYS,
                                    batch_size=BATCH, platform=dev.type),
                       clock=clock)
    be.warmup()
    ref.warmup()
    mesh_warm(be, ref, dev, "phase 16a")
    start = clone_table(be.table)
    batches = make_batches(np.random.default_rng(SEED + 1600))
    rec = MeshRecorder(be)
    got, check_s = [], 0.0
    try:
        serve_kernel.launches = 0
        for j, reqs in enumerate(batches):
            clock.freeze(T0_NS + j * 250_000_000)
            t0 = time.perf_counter()
            got.append(be.check(reqs))
            check_s += time.perf_counter() - t0
        k1n = serve_kernel.launches
    finally:
        rec.close()
    if k1n != CHECK_BATCHES * n or rec.k1_launches() != k1n:
        raise AssertionError(f"16a: {k1n} K1 launches ({rec.k1_launches()} "
                             f"recorded) for {CHECK_BATCHES} check() calls "
                             f"on {n} shards")
    MESH_PATHS["serve_kernel"]["phase 16a"] = k1n
    for j, reqs in enumerate(batches):
        clock.freeze(T0_NS + j * 250_000_000)
        want = ref.check(reqs)
        if [resp_tuple(r) for r in got[j]] != [resp_tuple(r) for r in want]:
            diff = [(reqs[i].hash_key(), resp_tuple(a), resp_tuple(b))
                    for i, (a, b) in enumerate(zip(got[j], want))
                    if resp_tuple(a) != resp_tuple(b)]
            raise AssertionError(f"16a check() {j}: {len(diff)} answers "
                                 f"differ from the single table's (key, "
                                 f"mesh, single): {diff[:4]}")
    t0 = time.perf_counter()
    err = rec.replay(dev, {"auth": start})
    log(f"phase 16a: {CHECK_BATCHES} check() x {BATCH} requests on "
        f"{n} shards: {k1n} K1 launches (one a shard a check()), every "
        f"answer equal to the single-table TorchBackend's on the same "
        f"clock; {len(rec.events)} per-shard launches replayed through the "
        f"plain version on a copy of the shards' views in "
        f"{time.perf_counter() - t0:.3f} s: responses, table, claim words "
        f"bit-exact; occupancy {be.occupancy()}")

    # Timing: check 0's launches again, per shard and as one dispatch.
    l2_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = l2_buf.zero_
    first = [ev for ev in rec.events[:n]]
    nows, k = first[0][4], first[0][3].shape[0]
    seq1 = torch.zeros(1, dtype=torch.int64, device=dev)
    scratch = be._scratch_for(k, first[0][3].shape[2])
    per_shard, bounds = [], []
    for _, _, s, qs, _, _, resps in first:
        view, claim = shard_view(be.table, s, n), claim_view(be.claim, s, n)
        per_shard.append(cuda_ms(lambda: serve_kernel.persistent_serve_step(
            view, qs, nows, seq1, WAYS, claim, scratch), 10, flush))
        bounds.append(useful_bytes(qs, resps, WAYS) / hbm_bytes_per_s(name)
                      * 1e3)
    block = torch.stack([ev[3] for ev in first], dim=2).contiguous()
    seqn = torch.zeros(n, dtype=torch.int64, device=dev)
    grid_ms = cuda_ms(lambda: mesh_ring_step(
        be.table, block, nows, seqn, n, WAYS, be.claim, scratch), 10, flush)
    plain_ms = cuda_ms(lambda: [ring_step(shard_view(start, ev[2], n),
                                          ev[3], nows, seq1, WAYS)
                                for ev in first], 2, flush)
    _, busy, by_name = profile_device(lambda: mesh_ring_step(
        be.table, block, nows, seqn, n, WAYS, be.claim, scratch))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"phase 16a ({smi}): torch.profiler, one dispatch of {n}: device "
        f"busy {busy:.4f} ms; " + "; ".join(f"{k} {v:.4f} ms" for k, v in top)
        if by_name else "phase 16a: torch.profiler recorded no device time "
        "for one dispatch")
    log(f"phase 16a ({smi}): K1 on one shard's views (qs "
        f"{list(first[0][3].shape)}, L2 flushed), ms per launch by shard: "
        + ", ".join(f"{m:.4f}" for m in per_shard)
        + f"; one dispatch of {n} (the block's shard-major copy included) "
        f"{grid_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
        f"{sum(bounds):.4f} ms (by shard "
        + ", ".join(f"{b:.4f}" for b in bounds) + ")")
    per = 1e3 / CHECK_BATCHES
    clock.freeze(T0_NS + CHECK_BATCHES * 250_000_000)
    wall_ms, busy_ms, by_name = profile_check(be, batches[0])
    busy = (f"device busy {busy_ms:.4f} ms ({busy_ms / wall_ms:.4%})"
            if busy_ms > 0 else "device busy share not measured (no "
            "device events)")
    log(f"phase 16a ({smi}): check() of {BATCH} requests on {n} shards: "
        f"{check_s * per:.3f} ms mean (host clock); torch.profiler, one "
        f"check(): {wall_ms:.3f} ms wall, {busy}")
    MESH_TIMES.update(per_shard_ms=per_shard, grid_ms=grid_ms,
                      plain_ms=plain_ms, bound_ms=sum(bounds))
    del l2_buf, start, rec
    return be, ref, err



def global_reqs(rng, ids):
    """GLOBAL requests on the keys `ids` (token:leaky 2:1; each key's
    parameters fixed)."""
    from gubernator_tpu_torch.core.types import (
        Algorithm,
        Behavior,
        RateLimitReq,
    )

    hits = rng.choice([1, 1, 1, 2, 3], len(ids))
    return [RateLimitReq(
        name="glob", unique_key=f"g{i}", hits=int(h),
        limit=(100, 1000, 10_000)[i % 3], duration=60_000,
        algorithm=(Algorithm.LEAKY_BUCKET if i % 3 == 2
                   else Algorithm.TOKEN_BUCKET),
        behavior=Behavior.GLOBAL) for i, h in zip(ids.tolist(), hits)]


def cache_rows(be, eng, keys, now):
    """(status, limit, remaining, expire_at) of each key's row in the
    engine's cache, read at its serving shard."""
    import torch

    from gubernator_tpu_torch.core.hashing import key_hash64

    with eng._lock:
        found, slot = be._probe_grid(
            keys, [key_hash64(k) for k in keys], now,
            table=eng.cache_table, route=eng._arrival)
        at = torch.from_numpy(slot).to(eng.cache_table.key.device)
        cols = [getattr(eng.cache_table, f)[at].cpu().numpy()
                for f in ("status", "limit", "remaining", "expire_at")]
    return [tuple(int(c[i]) for c in cols) if found[i] else None
            for i in range(len(keys))]


def row_tuples(items, keys):
    """The state of each key's CacheItem, comparable across backends."""
    return [None if k not in items else (
        int(items[k].algorithm), items[k].limit, items[k].duration, float(items[k].remaining),
        items[k].created_at, int(items[k].status), items[k].burst,
        items[k].expire_at) for k in keys]


def phase_mesh_global(dev, smi, be, ref, clock):
    """16b: the collective GLOBAL engine (psum) over 16a's mesh; after
    each sync the auth rows equal the single table's after the same
    per-sync aggregates, and the cache rows its hits=0 answers; one more
    window under a2a on cloned tables agrees with psum; every K1 launch and
    broadcast upsert replayed.  Returns max_abs_err."""
    from dataclasses import replace as dc_replace

    import torch

    from gubernator_tpu_torch.ops.kernels import serve_kernel
    from gubernator_tpu_torch.ops.state import clone_table
    from gubernator_tpu_torch.parallel.global_sync import GlobalEngine
    from gubernator_tpu_torch.parallel.sharded import MeshBackend

    n = be.n
    eng = GlobalEngine(be, batch_limit=1 << 30)  # the script syncs at 1000
    eng.warmup()
    rng = np.random.default_rng(SEED + 1602)
    w = 1.0 / np.arange(1, MESH_GLOBAL_KEYS + 1) ** MESH_ZIPF_S
    w /= w.sum()
    starts = {"auth": clone_table(be.table),
              "cache": clone_table(eng.cache_table)}
    rec = MeshRecorder(be, eng)
    pend, seen, stats = {}, {}, []
    eng_launches = 0
    t_now = T0_NS + 10 * 250_000_000

    def do_sync():
        nonlocal eng_launches
        keys = list(pend)
        before, ev0 = serve_kernel.launches, rec.k1_launches("auth")
        t0 = time.perf_counter()
        if eng.sync() != len(keys):
            raise AssertionError("16b: the sync missed pending keys")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        eng_launches += serve_kernel.launches - before
        stats.append((ms, len(keys), rec.k1_launches("auth") - ev0))
        ref.check([dc_replace(r, hits=h) for r, h in pend.values()])
        answers = ref.check([dc_replace(r, hits=0) for r, _ in pend.values()])
        now = clock.millisecond_now()
        want = [(int(a.status), a.limit, a.remaining, a.reset_time)
                for a in answers]
        if cache_rows(be, eng, keys, now) != want:
            raise AssertionError(f"16b sync {len(stats)}: cache rows differ "
                                 "from the broadcast answers")
        names = list(seen)
        if row_tuples(be.read_items_bulk(names), names) != row_tuples(
                ref.read_items_bulk(names), names):
            raise AssertionError(f"16b sync {len(stats)}: auth rows differ "
                                 "from the single table's")
        pend.clear()

    try:
        serve_kernel.launches = 0
        for call in range(MESH_GLOBAL_CALLS):
            t_now += 5_000_000
            clock.freeze(t_now)
            reqs = global_reqs(rng, rng.choice(MESH_GLOBAL_KEYS,
                                               MESH_GLOBAL_REQS, p=w))
            first = {}
            for r in reqs:
                key = r.hash_key()
                seen[key] = r
                a = first.get(key)
                first[key] = (r if a is None else a[0],
                              r.hits + (0 if a is None else a[1]))
            for key, (r, h) in first.items():
                cur = pend.get(key)
                pend[key] = (r, h + (cur[1] if cur else 0))
            before = serve_kernel.launches
            eng.check(reqs)
            eng_launches += serve_kernel.launches - before
            if len(eng.pending) >= MESH_GLOBAL_LIMIT:
                do_sync()
        if pend:
            do_sync()
    finally:
        rec.close()
    MESH_PATHS["serve_kernel"]["phase 16b"] = eng_launches
    if not stats or eng_launches == 0:
        raise AssertionError("16b: no sync or no K1 launch")
    t0 = time.perf_counter()
    err = rec.replay(dev, starts)
    ms = [s[0] for s in stats]
    log(f"phase 16b ({smi}): {MESH_GLOBAL_CALLS} GLOBAL check() x "
        f"{MESH_GLOBAL_REQS} over {MESH_GLOBAL_KEYS} keys (Zipf s = "
        f"{MESH_ZIPF_S}) with {len(stats)} psum syncs: ms per sync mean "
        f"{np.mean(ms):.3f}, p50 {np.percentile(ms, 50):.3f}, max "
        f"{max(ms):.3f} (host clock, the write-through-free sync); keys per "
        f"sync mean {np.mean([s[1] for s in stats]):.1f}; K1 launches per "
        f"sync {sorted(set(s[2] for s in stats))} ({n} a chunk); engine K1 "
        f"launches {eng_launches}; after every sync the auth rows equal the "
        f"single table's and the cache rows its hits=0 answers; "
        f"{len(rec.events)} events (K1 launches and broadcast upserts) "
        f"replayed bit-exact in {time.perf_counter() - t0:.3f} s")
    del starts, rec

    # One more window under a2a on cloned tables: every answer agrees.
    be2 = MeshBackend(be.cfg, clock=clock)
    be2.table = clone_table(be.table)
    eng2 = GlobalEngine(be2, collective="a2a", batch_limit=1 << 30)
    eng2.cache_table = clone_table(eng.cache_table)
    reqs_all = []
    for call in range(MESH_A2A_CALLS):
        t_now += 5_000_000
        clock.freeze(t_now)
        reqs = global_reqs(rng, rng.choice(MESH_GLOBAL_KEYS,
                                           MESH_GLOBAL_REQS, p=w))
        reqs_all += reqs
        a, b = eng.check(reqs), eng2.check(reqs)
        if [resp_tuple(x) for x in a] != [resp_tuple(x) for x in b]:
            raise AssertionError("16b: a2a answers differ from psum's")
    synced = (eng.sync(), eng2.sync())
    keys = sorted({r.hash_key() for r in reqs_all})
    now = clock.millisecond_now()
    if synced[0] != synced[1] or cache_rows(be, eng, keys, now) != \
            cache_rows(be2, eng2, keys, now) or row_tuples(
                be.read_items_bulk(keys), keys) != row_tuples(
                be2.read_items_bulk(keys), keys):
        raise AssertionError("16b: the a2a sync disagrees with psum")
    log(f"phase 16b: one more window ({MESH_A2A_CALLS} calls, {synced[0]} "
        f"keys) synced under psum and under a2a on cloned tables: every "
        f"answer, cache row and auth row agrees")
    del be2, eng2
    return err, eng


def mesh_rpc_requests(rng, n_rpc: int, first_key: int):
    """GetRateLimits payloads of RPC_REQS requests: 1/8 GLOBAL over
    MESH_DAEMON_GLOBAL_KEYS keys, 1/8 on the sketch tier's name, the rest
    the exact tier's mix (rpc_requests)."""
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    out = []
    for p in rpc_requests(rng, n_rpc, first_key=first_key):
        msg = pb.GetRateLimitsReq.FromString(p)
        glob = np.flatnonzero(
            (rng.random(RPC_REQS) < 1 / 7)
            & np.array([r.name != "cms" for r in msg.requests]))
        ids = rng.integers(0, MESH_DAEMON_GLOBAL_KEYS, len(glob))
        for j, i in zip(glob.tolist(), ids.tolist()):
            r = msg.requests[j]
            r.name, r.unique_key, r.hits = "glob", f"g{i}", 1
            r.limit, r.duration, r.behavior = 100_000, 60_000, 2
            r.algorithm = int(i % 3 == 2)
        out.append(msg.SerializeToString())
    return out


def mesh_mode_run(dev, smi, mode, slots, clients, warm, seed, label):
    """16c: one serve mode on a mesh daemon built from GUBER_MESH_WAYS,
    with the sketch tier; every K1 and K2 dispatch recorded and replayed
    after the daemon stops.  Returns max_abs_err."""
    import os

    import torch

    from gubernator_tpu_torch.core.config import mesh_ways_from_env
    from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel
    from gubernator_tpu_torch.ops.sketch import clone_sketch
    from gubernator_tpu_torch.ops.state import clone_table
    from gubernator_tpu_torch.parallel.sharded import MeshBackend

    os.environ["GUBER_MESH_WAYS"] = str(MESH_SHARDS)
    c = start_daemons(dev, 1, slots, mode, shards=mesh_ways_from_env())
    rec = None
    try:
        d = c.daemons[0]
        be, eng = d.service.backend, d.service.global_engine
        sb, fp = d.service.sketch_backend, d.fastpath
        want = "megaround" if mode == "persistent" else mode
        if (not isinstance(be, MeshBackend) or eng is None
                or be.device.type != dev.type
                or fp.effective_serve_mode != want):
            raise AssertionError(f"16c {mode}: {type(be).__name__} on "
                                 f"{be.device}, serving "
                                 f"{fp.effective_serve_mode}")
        if mode == "persistent":
            log(f"{label}: GUBER_SERVE_MODE=persistent on the mesh serves "
                f"{fp.effective_serve_mode}: {fp.persistent_status}")
        if warm:
            mesh_warm(be, None, dev, label)
        torch.cuda.synchronize()
        starts = {"auth": clone_table(be.table),
                  "cache": clone_table(eng.cache_table)}
        sketch = clone_sketch(sb.state)
        rng = np.random.default_rng(seed)
        per_client = [mesh_rpc_requests(rng, MESH_RPCS, 1 + 10_000 * j)
                      for j in range(clients)]
        rec = MeshRecorder(be, eng, sb)
        serve_kernel.launches = cms_kernel.launches = 0
        wall, lat, counts = c.run(drive_rpcs(d.grpc_address, per_client),
                                  timeout=900)
        k1, k2 = serve_kernel.launches, cms_kernel.launches
        n_req = clients * MESH_RPCS * RPC_REQS
        if sum(counts) != n_req or k1 == 0 or k2 == 0:
            raise AssertionError(f"16c {mode}: {sum(counts)} of {n_req} "
                                 f"answers, K1 launches {k1}, K2 {k2}")
        MESH_PATHS["serve_kernel"][f"phase 16c {mode}"] = k1
        MESH_PATHS["cms_kernel"][f"phase 16c {mode}"] = k2
        dvars = http_json(d.http_address, "/debug/vars")
        occ = dvars["backend"].get("shard_occupancy")
        if (not occ or len(occ) != MESH_SHARDS
                or sum(occ) != be.occupancy()):
            raise AssertionError(f"16c {mode}: /debug/vars shard_occupancy "
                                 f"{occ}, occupancy {be.occupancy()}")
        p50, p99, _ = percentiles_ms(lat)
        lanes = fp.debug_vars()["lanes"]
        log(f"{label} ({smi}): {mode} mesh daemon ({MESH_SHARDS} shards from "
            f"GUBER_MESH_WAYS, {slots} slots): {clients} clients x "
            f"{MESH_RPCS} RPCs x {RPC_REQS} (1/8 GLOBAL over "
            f"{MESH_DAEMON_GLOBAL_KEYS} keys, 1/8 cms): {n_req / wall:.1f} "
            f"decisions/s; per-RPC p50 {p50:.3f} ms, p99 {p99:.3f} ms (host "
            f"clock); K1 launches {k1}, K2 launches {k2}; engine syncs "
            f"{eng.syncs}; /debug/vars shard_occupancy {occ} (sum = "
            f"occupancy); fallbacks {fp.fallbacks}; lanes: " + "; ".join(
                f"{lane} {v['drains']} merges, dispatch "
                f"{v['dispatch_ms_total']:.1f}, fetch "
                f"{v['fetch_ms_total']:.1f}, waiting for a fetch slot "
                f"{v['bubble_ms_total']:.1f} ms"
                for lane, v in lanes.items()))
        if fp.fallbacks or (fp._ring is not None and (
                fp._ring.seq_mismatches or sum(fp.blocking_fetches.values()))):
            raise AssertionError(f"16c {mode}: fallbacks {fp.fallbacks}, "
                                 f"blocking fetches {fp.blocking_fetches}")
        require_planes_inactive(f"{label} ({mode})", c.daemons)
        c.stop()  # the final sync runs at close and is recorded
        c = None
        t0 = time.perf_counter()
        rec.close()
        err = rec.replay(dev, starts, sketch)
        log(f"{label}: {mode}: {rec.k1_launches()} per-shard K1 launches, "
            f"{len(rec.k2)} K2 dispatches and "
            f"{len(rec.events) - rec.k1_launches()} broadcast upserts "
            f"replayed through the plain versions after the daemon stopped "
            f"({time.perf_counter() - t0:.3f} s): responses, auth and cache "
            f"tables, sketch, claim words bit-exact")
        rec = None
        return err
    finally:
        if rec is not None:
            rec.close()
        if c is not None:
            c.stop()
        os.environ.pop("GUBER_MESH_WAYS", None)


def phase_mesh(dev, smi, name) -> float:
    """Phase 16: the sharded table on one card at the north star's mesh
    deployment.  Returns max_abs_err over every replay."""
    import torch

    from gubernator_tpu_torch.core.clock import Clock

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    clock = Clock()
    clock.freeze(T0_NS)
    be, ref, err = phase_mesh_library(dev, smi, name, clock)
    e, eng = phase_mesh_global(dev, smi, be, ref, clock)
    err = max(err, e)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del be, ref, eng
    torch.cuda.empty_cache()
    log(f"phase 16a-b ({smi}): peak device memory {peak:.2f} GiB (the mesh "
        f"table, the engine's cache, the single table and the replay "
        f"copies); freed before 16c")
    torch.cuda.reset_peak_memory_stats()
    for j, (mode, slots, clients, warm) in enumerate((
            ("pipelined", DAEMON_SLOTS, MESH_CLIENTS, True),
            ("megaround", SMALL_SLOTS, MESH_SMALL_CLIENTS, False),
            ("persistent", SMALL_SLOTS, MESH_SMALL_CLIENTS, False))):
        err = max(err, mesh_mode_run(dev, smi, mode, slots, clients, warm,
                                     SEED + 1610 + j, "phase 16c"))
    log(f"phase 16 ({smi}): {time.perf_counter() - t_phase:.1f} s; peak "
        f"device memory in 16c {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    return err


# -- phase 17: the benchmark entry points ----------------------------------
BENCH_SLOTS = 1 << 24        # cli/bench's geometry (its CLI passes 2^24)
BENCH_SPOT_KEYS = 65_536     # keys of staged batch 0 the spot check reads
BENCH_E2E_SECONDS = 1.0
BENCH_E2E_CONCURRENCY = 8    # cli/bench_e2e's default
MICROBENCH_ARGS = ["--seconds", "1", "--recompile-audit"]
BENCH_PATHS = {"serve_kernel": {}, "cms_kernel": {}}  # path -> launches


def count_path(label: str) -> None:
    """Record the K1 and K2 launches since the counters were set to 0 as
    the launches of path `label`."""
    from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel

    BENCH_PATHS["serve_kernel"][label] = serve_kernel.launches
    BENCH_PATHS["cms_kernel"][label] = cms_kernel.launches
    log(f"{label}: K1 launches {serve_kernel.launches}, K2 launches "
        f"{cms_kernel.launches}")


def zero_counts() -> None:
    from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel

    serve_kernel.launches = 0
    cms_kernel.launches = 0


class FirstDispatchReplay:
    """17b-17c's witness that the harnesses' K1 and K2 dispatches give the
    plain versions' answers.  Wraps K1 where it is called (the module
    attribute serve_kernel.persistent_serve_step and the name
    runtime/backend.py imported from it), K2 (cms_kernel.cms_multi_step)
    and Cluster.start_with, which opens an epoch: one cluster of a
    harness.  In each epoch the first REPLAYS dispatches on each table (or
    shard) and each sketch that carry a hit are replayed at once, before
    their caller goes on: through the plain ring_step or multi_step, on a copy
    of the table or sketch as it was before the dispatch, on the card.  It
    must equal the kernel bit for bit: responses, sequence word, the table
    or sketch after, the claim words.  A dispatch is looked at only when
    its stream is idle, so that no probe syncs behind queued work (a
    measurement's dispatches queued behind a spinning kernel); at most
    PROBES are looked at a table and epoch.  A mismatch is kept and raised by check(),
    not in the serving thread."""

    PROBES = 64
    REPLAYS = 4

    def __init__(self, label: str):
        import threading

        from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel
        from gubernator_tpu_torch.runtime import backend
        from gubernator_tpu_torch.testing.cluster import Cluster

        self.label = label
        self.lock = threading.Lock()
        self.epoch = 0
        self.probes = {}  # (epoch, kind, data_ptr) -> [probes, replays]
        self.k1_launches = {}  # epoch -> K1 dispatches
        self.replayed = {"k1": {}, "k2": {}}  # kind -> epoch -> replays
        self.lanes = 0
        self.failures = []
        self.err = 0.0
        self._k1 = serve_kernel.persistent_serve_step
        self._k2 = cms_kernel.cms_multi_step
        self._start = Cluster.__dict__["start_with"]
        start = self._start.__func__

        def start_with(cls, *a, **k):
            with self.lock:
                self.epoch += 1
            return start(cls, *a, **k)

        serve_kernel.persistent_serve_step = self.k1
        backend.persistent_serve_step = self.k1
        cms_kernel.cms_multi_step = self.k2
        Cluster.start_with = classmethod(start_with)

    def close(self) -> None:
        from gubernator_tpu_torch.ops.kernels import cms_kernel, serve_kernel
        from gubernator_tpu_torch.runtime import backend
        from gubernator_tpu_torch.testing.cluster import Cluster

        serve_kernel.persistent_serve_step = self._k1
        backend.persistent_serve_step = self._k1
        cms_kernel.cms_multi_step = self._k2
        Cluster.start_with = self._start

    def _wanted(self, kind, t, has_hit):
        """The epoch if this dispatch is to be replayed, else None."""
        import torch

        with self.lock:
            ep = self.epoch
            if kind == "k1":
                self.k1_launches[ep] = self.k1_launches.get(ep, 0) + 1
            n = self.probes.setdefault((ep, kind, t.data_ptr()), [0, 0])
            if n[0] >= self.PROBES or n[1] >= self.REPLAYS:
                return None
            if t.device.type == "cuda" and not torch.cuda.current_stream(
                    t.device).query():
                return None
            n[0] += 1
        if not has_hit():
            return None
        with self.lock:
            n[1] += 1
        return ep

    def _done(self, kind, ep, ok, what, err) -> None:
        with self.lock:
            by = self.replayed[kind]
            by[ep] = by.get(ep, 0) + 1
            self.err = max(self.err, err)
            if not ok:
                self.failures.append(f"{kind} in cluster {ep}: {what}")

    def k1(self, table, qs, nows, seq, ways=8, claim=None, scratch=None):
        import torch

        from gubernator_tpu_torch.ops.kernels import serve_kernel
        from gubernator_tpu_torch.ops.ring import ring_step
        from gubernator_tpu_torch.ops.state import clone_table

        ep = self._wanted("k1", table.key, lambda: bool(
            ((qs[:, 10] != 0) & (qs[:, 1] != 0)).any()))
        if ep is None:
            return self._k1(table, qs, nows, seq, ways, claim, scratch)
        before = clone_table(table)
        out = self._k1(table, qs, nows, seq, ways, claim, scratch)
        _, pr, ps = ring_step(before, qs, nows, seq, ways)
        what = [n for n, same in (
            ("responses", torch.equal(pr, out[1])),
            ("sequence word", torch.equal(ps, out[2])),
            ("table", tables_equal(out[0], before)),
            ("claim words", claim is None or bool(
                (claim == serve_kernel.INT32_MAX).all()))) if not same]
        with self.lock:
            self.lanes += int((qs[:, 10] != 0).sum())
        self._done("k1", ep, not what, what, max_abs_err(pr, out[1]))
        return out

    def k2(self, state, kh, hits, lim, now):
        import torch

        from gubernator_tpu_torch.ops.sketch import SketchState, multi_step

        ep = self._wanted("k2", state.cur, lambda: bool((hits != 0).any()))
        if ep is None:
            return self._k2(state, kh, hits, lim, now)
        before = SketchState(*[x.clone() for x in state])
        out = self._k2(state, kh, hits, lim, now)
        ps, pp = multi_step(before, kh, hits, lim, int(now))
        what = [n for n, same in (
            ("outputs", torch.equal(pp, out[1])),
            ("sketch", sketch_equal(out[0], ps))) if not same]
        self._done("k2", ep, not what, what, max_abs_err(pp, out[1]))
        return out

    def check(self, need_k2: bool) -> float:
        """Fails on a mismatch, on no replay of a kernel the path needs,
        and on a cluster that launched more than PROBES K1 dispatches with
        none replayed.  Returns max_abs_err over the replays."""
        if self.failures:
            raise AssertionError(f"{self.label}: replays differ from the "
                                 f"plain versions: {self.failures}")
        k1, k2 = self.replayed["k1"], self.replayed["k2"]
        bare = {ep: n for ep, n in self.k1_launches.items() if ep not in k1}
        if (not k1 or (need_k2 and not k2)
                or any(n > self.PROBES for n in bare.values())):
            raise AssertionError(
                f"{self.label}: K1 replays by cluster {k1}, K2 {k2}; K1 "
                f"dispatches of the clusters with none replayed: {bare}")
        log(f"{self.label}: {sum(k1.values())} K1 dispatches ({self.lanes} "
            f"active lanes) in {len(k1)} of {len(self.k1_launches)} "
            f"clusters and {sum(k2.values())} K2 dispatches replayed "
            f"bit-exact through the plain versions; K1 dispatches of the "
            f"clusters with none replayed (no hit among the first "
            f"{self.PROBES}): {bare}")
        return self.err


def phase_bench(dev, name: str, smi: str) -> float:
    """17a: cli/bench at 2^24 slots and 10M keys, B = 262144, fed 4096.
    Records the first timed K1 dispatch (the table before and after it, its
    round and responses) and replays it through the plain ring_step on the
    CPU; spot-checks staged batch 0's rows; times one 262144-lane round.
    Returns max_abs_err of the replay."""
    import torch

    from gubernator_tpu_torch.cli import bench
    from gubernator_tpu_torch.ops.kernels import serve_kernel
    from gubernator_tpu_torch.ops.ring import ring_step
    from gubernator_tpu_torch.ops.state import SlotTable, clone_table
    from gubernator_tpu_torch.ops.step import gather_rows

    t_phase = time.perf_counter()
    k1 = serve_kernel.persistent_serve_step
    rec = {}
    seen = [0]

    def recording(table, qs, nows, seq, ways=8, claim=None, scratch=None):
        seen[0] += qs.shape[0] == 1
        if seen[0] != 3 or qs.shape[0] != 1 or rec:
            return k1(table, qs, nows, seq, ways, claim, scratch)
        # The third one-round dispatch is the first timed one: the populate
        # dispatches many rounds, two warm-up rounds go before it, and the
        # fed rounds come after the kernel metric.
        rec["before"] = clone_table(table)
        out = k1(table, qs, nows, seq, ways, claim, scratch)
        rec.update(after=clone_table(out[0]), qs=qs.clone(),
                   nows=nows.clone(), seq=seq.clone(), resps=out[1].clone())
        return out

    serve_kernel.persistent_serve_step = recording
    zero_counts()
    try:
        r = bench.run(BENCH_SLOTS, dev)
    finally:
        serve_kernel.persistent_serve_step = k1
    count_path("phase 17a: cli/bench")
    line = r.line
    log(f"phase 17a: {json.dumps(line)}")
    bad = sorted((bench.FAILED_KEYS | {"skipped"}) & set(line))
    if bad or BENCH_PATHS["serve_kernel"]["phase 17a: cli/bench"] == 0:
        raise AssertionError(f"phase 17a: bench line has {bad}")
    # The claim words are shared by the table and the fed phase's clone.
    if dev.type == "cuda" and not bool(
            (r.claim == serve_kernel.INT32_MAX).all()):
        raise AssertionError("phase 17a: claim words not restored")
    if not rec:
        raise AssertionError("phase 17a: no timed dispatch recorded")
    # Replay the recorded dispatch on the CPU.
    t0 = time.perf_counter()
    cpu = SlotTable(*[c.cpu() for c in rec["before"]])
    cpu, presps, pseq = ring_step(cpu, rec["qs"].cpu(), rec["nows"].cpu(),
                                  rec["seq"].cpu(), WAYS)
    kresps = rec["resps"].cpu()
    if not torch.equal(kresps, presps):
        bad = (kresps != presps).nonzero()[:5].tolist()
        raise AssertionError(f"phase 17a: responses differ at {bad}")
    if not tables_equal(SlotTable(*[c.cpu() for c in rec["after"]]), cpu):
        raise AssertionError("phase 17a: table after the dispatch differs "
                             "from the plain replay's")
    err = max_abs_err(kresps, presps)
    act = rec["qs"][:, 10] != 0
    log(f"phase 17a: timed dispatch (qs {list(rec['qs'].shape)}, "
        f"{int(act.sum())} active, {int(kresps[:, 5].sum())} found) "
        f"replayed bit-exact through the plain ring_step on the CPU in "
        f"{time.perf_counter() - t0:.1f} s")
    del rec["before"], rec["after"], cpu
    # Spot check over the first BENCH_SPOT_KEYS keys of staged batch 0,
    # whose hits are the populate's one and one a round that carried them.
    # A key whose bucket holds at most INSERT_ROUNDS keys of the pool is
    # never evicted and no claim round runs out for it: it holds exactly
    # 1000 - hits.  At the bench's ~60% load a fuller bucket evicts rows
    # (and a fourth new key of a bucket in one round is answered but not
    # stored), as in the JAX package (tests/test_torch_bench.py holds the
    # two packages' tables equal at that load): such a key either holds
    # what the hits since it last entered left, 1000 - hits up to 999, or
    # is missing from a bucket whose ways all hold other live keys.
    from gubernator_tpu_torch.ops.step import INSERT_ROUNDS

    nb = BENCH_SLOTS // WAYS
    per_bucket = np.bincount(r.key_pool & (nb - 1), minlength=nb)
    sample = r.staged_idx[0][:BENCH_SPOT_KEYS]
    keys = r.key_pool[sample]
    small = per_bucket[keys & (nb - 1)] <= INSERT_ROUNDS
    times = np.bincount(r.applied, minlength=bench.N_STAGED)
    hits = 1 + sum(int(times[i]) * np.isin(sample, r.staged_idx[i])
                   for i in range(bench.N_STAGED))
    packed, rf = gather_rows(r.table, torch.from_numpy(keys).to(dev),
                             r.now, WAYS)
    packed, rf = packed.cpu().numpy(), rf.cpu().numpy()
    rows = ((keys & (nb - 1))[:, None] * WAYS + np.arange(WAYS)).ravel()
    ways_keys = r.table.key[torch.from_numpy(rows).to(dev)].cpu().numpy()
    ways_keys = ways_keys.reshape(-1, WAYS)
    found = packed[0] == 1
    want = np.maximum(1000 - hits, 0)
    got = np.where(packed[2] == 1, rf, packed[5])
    full = (ways_keys != 0).all(axis=1) & (ways_keys != keys[:, None]).all(
        axis=1)
    bad = {
        "small bucket, not exact": int((small & ~(found & (got == want)))
                                       .sum()),
        "found, outside 1000 - hits..999": int(
            (found & ((got < want) | (got > 999))).sum()),
        "missing from a bucket with room": int((~found & ~full).sum()),
    }
    if int(small.sum()) < BENCH_SPOT_KEYS // 8 or any(bad.values()):
        raise AssertionError(f"phase 17a: spot check failed over "
                             f"{len(sample)} keys ({int(small.sum())} in "
                             f"small buckets): {bad}")
    log(f"phase 17a: spot check: {len(sample)} keys of staged batch 0: "
        f"{int(small.sum())} in buckets of <= {INSERT_ROUNDS} pool keys "
        f"hold 1000 - hits; of the rest {int((found & ~small).sum())} "
        f"found ({int((found & ~small & (got == want)).sum())} at 1000 - "
        f"hits, the others re-entered), {int((~found).sum())} missing from "
        f"full buckets (hits {int(hits.min())}-{int(hits.max())}, "
        f"{len(r.applied)} rounds applied after the populate)")
    # K1 at one 262144-lane round, L2 flushed, beside its byte bound.
    qs, nows, seq = rec["qs"], rec["nows"], rec["seq"]
    scratch = torch.empty(serve_kernel.scratch_words(dev, 1, qs.shape[2]),
                          dtype=torch.int32, device=dev)
    kern = lambda: serve_kernel.persistent_serve_step(  # noqa: E731
        r.table, qs, nows, seq, WAYS, r.claim, scratch)
    _, first, _ = kern()
    bound = useful_bytes(qs, first, WAYS) / hbm_bytes_per_s(name) * 1e3
    kern()
    l2 = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = cuda_ms(kern, 20, l2.zero_)
    log(f"phase 17a ({smi}): kernel {line['value']:.1f} decisions/s, fed "
        f"{line['fed_decisions_per_sec']:.1f} decisions/s at "
        f"{line['fed_batch']} lanes; K1 at one {qs.shape[2]}-lane round "
        f"(L2 flushed): {ms:.4f} ms, bound {bound:.4f} ms (bytes); "
        f"{time.perf_counter() - t_phase:.1f} s")
    del r, rec, l2, scratch
    torch.cuda.empty_cache()
    return err


def phase_bench_e2e(smi: str) -> float:
    """17b: cli/bench_e2e with --seconds 1 --pipeline-depth 2 --serve-mode
    pipelined,persistent --client-mode python,native,leased, in this
    process.  Fails on any line with an error or a platform other than
    cuda, unless the cms config launched K2, and unless each cluster's
    first dispatches replay bit-exact (FirstDispatchReplay).  Returns
    max_abs_err of the replays."""
    from gubernator_tpu_torch.cli import bench_e2e

    t0 = time.perf_counter()
    zero_counts()
    rec = FirstDispatchReplay("phase 17b")
    try:
        # The harness's JSON lines go to stderr: stdout ends in the
        # result lines.
        with contextlib.redirect_stdout(sys.stderr):
            lines = bench_e2e.bench(
                BENCH_E2E_SECONDS, BENCH_E2E_CONCURRENCY, depth_sweep=(2,),
                serve_sweep=("pipelined", "persistent"),
                client_modes=("python", "native", "leased"))
    finally:
        rec.close()
    count_path("phase 17b: cli/bench_e2e")
    errors = [x for x in lines if "error" in x]
    if errors:
        raise AssertionError(f"phase 17b: lines with an error: {errors}")
    summary = lines[-1]
    if summary.get("platform") != "cuda":
        raise AssertionError(f"phase 17b: summary {summary}")
    if not (BENCH_PATHS["serve_kernel"]["phase 17b: cli/bench_e2e"]
            and BENCH_PATHS["cms_kernel"]["phase 17b: cli/bench_e2e"]):
        raise AssertionError("phase 17b: K1 or K2 never launched")
    err = rec.check(need_k2=True)
    by = {x["config"]: x for x in lines}
    bound = by["colocated_latency_bound"]
    log(f"phase 17b ({smi}): {len(lines)} lines in "
        f"{time.perf_counter() - t0:.1f} s; device_step_exec "
        f"{bound['device_step_exec_ms']} ms ({bound['device_step_exec_src']})"
        f"; merge turnaround {bound['rig_merge_turnaround_ms']} ms")
    for x in lines:
        if "checks_per_sec" in x:
            log(f"phase 17b: {x['config']}"
                f"{' ' + x['serve_mode'] if 'serve_mode' in x else ''}"
                f"{' ' + x['client_mode'] if 'client_mode' in x else ''}: "
                f"{x['checks_per_sec']} checks/s, p50 {x['p50_ms']} ms, "
                f"p99 {x['p99_ms']} ms")
    return err


def phase_microbench(smi: str) -> float:
    """17c: cli/microbench --seconds 1 --recompile-audit, in this process:
    six scenario lines with ops > 0, each kernel's library loaded, and
    each daemon's first dispatches replayed bit-exact
    (FirstDispatchReplay).  Returns max_abs_err of the replays."""
    import asyncio

    from gubernator_tpu_torch.cli import microbench

    zero_counts()
    rec = FirstDispatchReplay("phase 17c")
    try:
        with contextlib.redirect_stdout(sys.stderr):
            lines = asyncio.run(microbench.run(
                microbench.parse_args(MICROBENCH_ARGS)))
    finally:
        rec.close()
    count_path("phase 17c: cli/microbench")
    scen = [x for x in lines if x["scenario"] != "recompile_audit"]
    if len(scen) != 6 or not all(x["ops"] > 0 for x in scen):
        raise AssertionError(f"phase 17c: scenarios {scen}")
    audit = lines[-1]["kernels"]
    if any(k["builds"] != 1 for k in audit.values()):
        raise AssertionError(f"phase 17c: audit {audit}")
    for x in scen:
        log(f"phase 17c ({smi}): {x['scenario']}: {x['ops_per_sec']} ops/s, "
            f"p50 {x['p50_ms']} ms, p99 {x['p99_ms']} ms")
    log(f"phase 17c: recompile audit {json.dumps(audit)}")
    return rec.check(need_k2=True)


def phase_graft(dev) -> float:
    """17d: graft.entry()'s step once on the card against its plain version
    on the CPU, then dryrun_multichip(4) with every assertion.  Returns
    max_abs_err of the step."""
    import torch

    from gubernator_tpu_torch import graft
    from gubernator_tpu_torch.ops.state import SlotTable

    zero_counts()
    fn, (table, q, now) = graft.entry()
    table, resp = fn(table, q, now)
    torch.cuda.synchronize()
    pfn, (ptable, pq, pnow) = graft.entry(device="cpu")
    ptable, presp = pfn(ptable, pq, pnow)
    if not torch.equal(resp.cpu(), presp):
        raise AssertionError("phase 17d: entry() step differs from plain")
    if not tables_equal(SlotTable(*[c.cpu() for c in table]), ptable):
        raise AssertionError("phase 17d: entry() table differs from plain")
    graft.dryrun_multichip(4)
    count_path("phase 17d: graft")
    return max_abs_err(resp.cpu(), presp)


def phase_entry_points(dev, name: str, smi: str) -> float:
    """Phase 17: the benchmark entry points on the card.  Returns
    max_abs_err over its replays."""
    import torch

    from gubernator_tpu_torch.core import clock as clock_mod

    t_phase = time.perf_counter()
    err = phase_bench(dev, name, smi)
    # The JAX harnesses run on the live clock (a LeasedClient judges a
    # grant's expiry by time.time()).
    clock_mod.unfreeze()
    try:
        err = max(err, phase_bench_e2e(smi), phase_microbench(smi),
                  phase_graft(dev))
    finally:
        clock_mod.freeze(T0_NS)
    torch.cuda.synchronize()
    log(f"phase 17 ({smi}): {time.perf_counter() - t_phase:.1f} s")
    return err


STATE_OP_SOURCES = {
    "load_rows": ("gubernator_tpu_torch/ops/step.py",
                  "gubernator_tpu/ops/step.py:511"),
    "probe_batch": ("gubernator_tpu_torch/ops/step.py",
                    "gubernator_tpu/ops/step.py:549"),
    "gather_rows": ("gubernator_tpu_torch/ops/step.py",
                    "gubernator_tpu/ops/step.py:587"),
    "migrate_extract": ("gubernator_tpu_torch/ops/state.py",
                        "gubernator_tpu/ops/state.py:104"),
    "migrate_inject": ("gubernator_tpu_torch/ops/state.py",
                       "gubernator_tpu/ops/state.py:164"),
    "demote_extract": ("gubernator_tpu_torch/ops/state.py",
                       "gubernator_tpu/ops/state.py:261"),
    "table_stats": ("gubernator_tpu_torch/ops/state.py",
                    "gubernator_tpu/ops/state.py:373"),
}
STATE_PATHS = {}  # phase -> {op: launches in that phase's run}


def state_ops_line(times):
    """The state-plane ops' JSON: torch ops on the card, no hand kernel.
    Fails if a path launched none of an op it runs."""
    for path, need in STATE_PATH_OPS.items():
        missing = [n for n in need if not STATE_PATHS.get(path, {}).get(n)]
        if missing:
            raise AssertionError(f"{path}: no launch of {missing}")
    out = []
    for n in STATE_OPS:
        src, rep = STATE_OP_SOURCES[n]
        t = times.get(n, {})
        out.append({"name": n, "route": "torch", "source": src,
                    "replaces": rep,
                    "launches": {p: v.get(n, 0)
                                 for p, v in STATE_PATHS.items()},
                    "ms": t.get("ms"), "bound_ms": t.get("bound_ms"),
                    "bound_by": "bytes", "shape": t.get("shape")})
    return {"state_ops": out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script needs a CUDA card", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {name}; torch {torch.__version__} cuda {torch.version.cuda}")

    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.core import clock as clock_mod

    phase_build()
    if not native.available():
        raise RuntimeError("the native host runtime (native/gubtpu.cpp) "
                           "did not build: the compiled fast lane is off")
    k1 = k1_path(dev, name, smi)
    k2 = k2_path(dev, name, smi)
    clock_mod.freeze(T0_NS)  # the daemons' clock, frozen
    state, times = StateOpRecorder(), {}
    derr = max(daemon_path(dev, smi, phase10_state(state, dev, name, smi,
                                                   times)),
               cluster_path(dev, smi))
    derr = max(derr, phase_store(dev, smi, state),
               phase_reshard(dev, smi, state),
               phase_planes(dev, smi, state),
               phase_regions(dev, smi, state))
    state.close()
    merr = phase_mesh(dev, smi, name)
    berr = phase_entry_points(dev, name, smi)
    k1["max_abs_err"] = max(k1["max_abs_err"], derr, merr, berr)
    k2["max_abs_err"] = max(k2["max_abs_err"], derr, merr, berr)
    # Phases 16-17's launches by path, beside the main path's count.
    for k in (k1, k2):
        k["launches_by_path"] = {"main path": k["launches"],
                                 **MESH_PATHS[k["name"]],
                                 **BENCH_PATHS[k["name"]]}
    # The result lines carry no time prefix: they are parsed as JSON.
    print(json.dumps(state_ops_line(times)), flush=True)
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        rc = 1
    sys.exit(rc)
