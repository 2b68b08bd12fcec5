#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of gubernator on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build the serve kernel (csrc/serve_kernel.cu) with nvcc;
  2. run the kernel and its plain PyTorch version (ops/ring.ring_step) on
     seeded random tables and rounds that reach every branch of the
     decision step, and require them bit-exact;
  3. warm a 2^24-slot table to 10M live keys through the kernel;
  4. serve 8 check() batches of 32768 string-keyed requests (token and
     leaky, with duplicates) through TorchBackend, require one kernel launch
     per check(), hold every launch's responses (all lanes), every
     check() response and the final table bit-exact against the plain
     version run on a copy of the table, and require the claim words
     restored;
  5. time the kernel and the plain version with CUDA events (L2 flushed
     before each call), split check()'s host time, trace one check() with
     torch.profiler for the device's busy time, and print the kernel line,
     the card, and the result line.

Needs torch with CUDA and nvcc; imports no JAX.
"""
from __future__ import annotations

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


def log(*a) -> None:
    print(*a, flush=True)


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
    """One check() under torch.profiler.  Returns its wall ms, the ms in
    which the device was busy (the union of the trace's device events), and
    the device ms of each event name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        be.check(reqs)
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
    from gubernator_tpu_torch.ops.kernels import serve_kernel
    from gubernator_tpu_torch.ops.kernels.build import build

    t0 = time.perf_counter()
    built = build("serve_kernel")
    serve_kernel.library()
    log(f"phase 1: built {built.path.name} in {built.seconds:.3f} s of nvcc "
        f"({time.perf_counter() - t0:.3f} s with loading)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())


def phase_random(dev) -> float:
    """Kernel vs plain on branch-covering random tables and rounds."""
    import torch

    from gubernator_tpu_torch.ops.kernels.serve_kernel import (
        INT32_MAX,
        new_claim_buffer,
        persistent_serve_step,
    )
    from gubernator_tpu_torch.ops.ring import ring_step
    from gubernator_tpu_torch.ops.state import clone_table, table_from_host
    from gubernator_tpu_torch.testing import (
        KeySpace,
        random_rounds,
        random_table,
    )

    now = T0_NS // 1_000_000
    err = 0.0
    # (num_slots, B, k, hot buckets): small and crowded, the main path's
    # lane count, and more lanes than the grid has threads.
    cases = [(256, 64, 4, 4), (1 << 16, 4096, 4, 64),
             (1 << 20, BATCH, 3, 512), (1 << 20, 1 << 18, 2, 1024)]
    for n, (S, B, k, hot) in enumerate(cases):
        rng = np.random.default_rng(SEED + n)
        ks = KeySpace(rng, S, WAYS, hot_buckets=hot)
        host = random_table(rng, ks, now)
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
        log(f"phase 2: case {n} S={S} B={B} k={k}: bit-exact; lanes "
            f"active={int(act.sum())} found={int(pr[:, 5].sum())} "
            f"transient={int((act & (pr[:, 4] == 0)).sum())} "
            f"cached={int(pr[:, 7].sum())} over={int((pr[:, 0] == 1).sum())}")
        err = max(err, max_abs_err(kr, pr))
    return err


def phase_warm(be, dev) -> None:
    """Fill the table with synthetic fingerprints through the kernel."""
    import torch

    rng = np.random.default_rng(SEED)
    now = be.clock.millisecond_now()
    seq = be.ring_seq_init()
    k = 16
    fed = 0
    t0 = time.perf_counter()
    n_launch = 0
    while True:
        if fed >= WARM_KEYS:
            occ = be.occupancy()
            if occ >= WARM_KEYS:
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
        if fed >= WARM_KEYS:
            k = 1  # top up one round at a time
    torch.cuda.synchronize()
    log(f"phase 3: fed {fed} fingerprints in {n_launch} launches "
        f"({time.perf_counter() - t0:.3f} s); occupancy {occ} of "
        f"{NUM_SLOTS} slots; seq {int(seq)}")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; "
              "this script needs a CUDA card", file=sys.stderr)
        return 2

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

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {name}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()
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
    kernels = {"kernels": [{
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
    }]}
    log(json.dumps(kernels))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        rc = 1
    sys.exit(rc)
