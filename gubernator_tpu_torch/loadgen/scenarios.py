"""The scenario library (docs/loadgen.md): seven declarative open-loop
scenarios, each ending in a pass/fail verdict asserted from the merged
/debug/vars ledger — admission bounds exactly, shed/over-admission
attribution, reconvergence after heal.  No scenario reports latency
without proving its admission bound first.

Scenario windows (window_ms) always outlive the run, so every key
spans at most ONE rate-limit window and the bounds are exact counts,
not rate estimates.  Saturating scenarios (diurnal, burststorm,
flashcrowd) expect the default gubload env scale — shrink the run
far enough that nothing saturates and their denied>0 assertions fail
honestly rather than report a tail that proved nothing.
"""
from __future__ import annotations

import asyncio
from typing import Dict

import numpy as np

from .spec import (
    PhaseSpec,
    RunContext,
    ScenarioSpec,
    assert_admission_bound,
    assert_reconverged,
    merged_tenant,
)

WINDOW_MS = 300_000  # outlives any sane run: one window per key


def _exact_ledger(ctx: RunContext, facts: Dict) -> None:
    """Fault-free scenarios: the ledger and the client agree EXACTLY —
    every owner-side decision reached a client and vice versa."""
    totals = ctx.totals()
    assert facts["ledger_allowed"] == totals.admitted, (
        f"{ctx.spec.name}: ledger allowed {facts['ledger_allowed']} != "
        f"client-observed admitted {totals.admitted}"
    )
    assert facts["ledger_denied"] == totals.denied, (
        f"{ctx.spec.name}: ledger denied {facts['ledger_denied']} != "
        f"client-observed denied {totals.denied}"
    )
    assert totals.errors == 0, (
        f"{ctx.spec.name}: {totals.errors} errors in a fault-free run"
    )


# -- fault-free shape scenarios ----------------------------------------


def _steady_verdict(ctx: RunContext) -> Dict:
    facts = assert_admission_bound(ctx)
    _exact_ledger(ctx, facts)
    assert facts["ledger_denied"] == 0, (
        f"steady: {facts['ledger_denied']} denials under a "
        "non-saturating limit"
    )
    return facts


STEADY = ScenarioSpec(
    name="steady",
    description="Steady Poisson arrivals, uniform keys, non-saturating "
    "limit: the ledger and the client must agree exactly, zero denials.",
    phases=(
        PhaseSpec("warm", 0.25, "steady", "uniform",
                  params={}, target_rps=None),
        PhaseSpec("cruise", 0.75, "steady", "uniform", profile=True),
    ),
    limit=1_000_000, window_ms=WINDOW_MS, key_universe=64,
    tenant="load.steady", verdict=_steady_verdict,
)


def _diurnal_verdict(ctx: RunContext) -> Dict:
    facts = assert_admission_bound(ctx)
    _exact_ledger(ctx, facts)
    assert facts["ledger_denied"] > 0, (
        "diurnal: the crest never saturated any key — the wave proved "
        "nothing (raise GUBER_LOAD_TARGET_RPS / GUBER_LOAD_DURATION)"
    )
    return facts


DIURNAL = ScenarioSpec(
    name="diurnal",
    description="A compressed diurnal wave (sinusoidal rate, trough "
    "20% of crest): keys saturate at the crest, the exact bound holds.",
    phases=(
        PhaseSpec("wave", 1.0, "diurnal", "uniform",
                  params={"base_fraction": 0.2}, profile=True),
    ),
    limit=8, window_ms=WINDOW_MS, key_universe=32,
    tenant="load.diurnal", verdict=_diurnal_verdict,
)


def _burst_verdict(ctx: RunContext) -> Dict:
    facts = assert_admission_bound(ctx)
    _exact_ledger(ctx, facts)
    assert facts["ledger_denied"] > 0, (
        "burststorm: bursts never saturated any key (raise "
        "GUBER_LOAD_TARGET_RPS / GUBER_LOAD_DURATION)"
    )
    return facts


BURSTSTORM = ScenarioSpec(
    name="burststorm",
    description="Square-wave burst storm (bursts at full rate over a "
    "20% floor): saturation inside bursts, exact bound across them.",
    phases=(
        PhaseSpec("storm", 1.0, "burst", "uniform",
                  params={"base_fraction": 0.2}, profile=True),
    ),
    limit=10, window_ms=WINDOW_MS, key_universe=16,
    tenant="load.burst", verdict=_burst_verdict,
)


def _flashcrowd_verdict(ctx: RunContext) -> Dict:
    facts = assert_admission_bound(ctx)
    _exact_ledger(ctx, facts)
    assert facts["ledger_denied"] > 0, (
        "flashcrowd: the crowd never saturated the hot key (raise "
        "GUBER_LOAD_TARGET_RPS / GUBER_LOAD_DURATION)"
    )
    # The hot head: the most-drawn key across the run's schedules must
    # hold its limit EXACTLY — the whole point of a flash crowd.
    hot_idx = int(ctx.state["hot_key_idx"])
    totals = ctx.totals()
    hot_admitted = totals.per_key_admitted.get(hot_idx, 0)
    assert hot_admitted <= ctx.spec.limit, (
        f"flashcrowd: hot key {ctx.spec.key_name(hot_idx)} admitted "
        f"{hot_admitted} > limit {ctx.spec.limit}"
    )
    assert hot_admitted == ctx.spec.limit, (
        f"flashcrowd: hot key only admitted {hot_admitted}/"
        f"{ctx.spec.limit} — the crowd never arrived"
    )
    facts["hot_key"] = ctx.spec.key_name(hot_idx)
    facts["hot_key_admitted"] = hot_admitted
    return facts


FLASHCROWD = ScenarioSpec(
    name="flashcrowd",
    description="Zipfian hot-key flash crowd over a warm uniform "
    "floor: the hot head saturates its limit exactly, the global "
    "bound holds.",
    phases=(
        PhaseSpec("warm", 0.25, "steady", "uniform",
                  params={}, target_rps=None),
        PhaseSpec("crowd", 0.6, "steady", "zipf",
                  params={"s": 1.4}, profile=True),
        PhaseSpec("cool", 0.15, "steady", "uniform"),
    ),
    limit=40, window_ms=WINDOW_MS, key_universe=64,
    tenant="load.flash", verdict=_flashcrowd_verdict,
)


# -- reshard-under-churn -----------------------------------------------


async def _churn_join(ctx: RunContext) -> None:
    """Membership churn, live: boot a joiner and push it into the ring
    at phase entry, so this phase's arrivals flow WHILE handoff windows
    drain rows to the new owner."""
    from dataclasses import replace

    from ..core.config import fast_test_behaviors
    from ..daemon import Daemon

    cluster = ctx.cluster
    device = cluster.daemons[0].conf.device
    conf = ctx.state["conf_template"]

    async def boot():
        c = replace(
            conf,
            grpc_listen_address="127.0.0.1:0",
            http_listen_address="127.0.0.1:0",
            behaviors=fast_test_behaviors(),
            device=device,
        )
        d = Daemon(c)
        await d.start()
        d.conf.advertise_address = d.grpc_address
        return d

    joiner = await asyncio.to_thread(
        lambda: cluster.run(boot(), timeout=300.0)
    )
    ctx.state["joiner"] = joiner
    cluster.daemons.append(joiner)
    await asyncio.to_thread(
        lambda: cluster.run(cluster._push_peers(), timeout=60.0)
    )


async def _churn_leave(ctx: RunContext) -> None:
    """Graceful LEAVE mid-run: the joiner drains its rows back to the
    survivors and departs; the drain phase's arrivals land on the
    post-leave ring."""
    cluster = ctx.cluster
    joiner = ctx.state["joiner"]
    shipped = await asyncio.to_thread(
        lambda: cluster.run(joiner.drain(), timeout=60.0)
    )
    ctx.state["drain_shipped"] = shipped
    # The joiner's per-node tenant ledger departs with it; its FINAL
    # scrape keeps the run's merged accounting whole (spec.merged_tenant
    # extra_scrapes).  to_thread: the scrape is a blocking HTTP GET
    # against a server on THIS loop — inline it would deadlock.
    from ..cli import gubtop

    scrape = await asyncio.to_thread(gubtop.scrape, joiner.http_address)
    assert "error" not in scrape, (
        f"reshard_churn: departing joiner {joiner.http_address} "
        f"unscrapeable: {scrape.get('error')}"
    )
    ctx.state.setdefault("departed_scrapes", {})[
        joiner.http_address
    ] = scrape
    cluster.daemons.remove(joiner)
    await asyncio.to_thread(
        lambda: cluster.run(cluster._push_peers(), timeout=60.0)
    )
    await asyncio.to_thread(
        lambda: cluster.run(joiner.close(), timeout=60.0)
    )


def _churn_verdict(ctx: RunContext) -> Dict:
    t = merged_tenant(ctx.daemons, ctx.spec.tenant)
    # Rows that moved during a handoff window may over-admit through
    # the joiner's bounded .handoff-shadow carve — the ledger
    # attributes every such admission, so the exact bound is
    # limit x keys + the attributed carve (docs/resharding.md).
    shadow = t["over_admitted"].get("handoff-shadow", 0)
    facts = assert_admission_bound(ctx, extra_allowance=shadow)
    facts["handoff_shadow_admitted"] = shadow
    facts["drain_shipped"] = ctx.state.get("drain_shipped", 0)
    assert ctx.state.get("drain_shipped", 0) >= 0
    # Conservation across BOTH remaps: post-churn the survivors answer
    # every key error-free and no breaker is stuck.
    facts.update(assert_reconverged(ctx))
    return facts


RESHARD_CHURN = ScenarioSpec(
    name="reshard_churn",
    description="Open-loop traffic across a live JOIN + graceful "
    "LEAVE: handoff windows drain under load, admission stays inside "
    "limit x keys + the ledger-attributed handoff-shadow carve.",
    phases=(
        PhaseSpec("warm", 0.3, "steady", "uniform"),
        PhaseSpec("join", 0.4, "steady", "uniform", fault="join",
                  profile=True),
        PhaseSpec("leave", 0.3, "steady", "uniform", fault="leave"),
    ),
    limit=25, window_ms=WINDOW_MS, key_universe=48,
    tenant="load.churn", verdict=_churn_verdict,
    hooks={"join": _churn_join, "leave": _churn_leave},
    needs_cluster=True,
)


# -- partition-while-leased --------------------------------------------

_LEASE_FRACTION = 0.25
_LEASE_KEY_IDX = 0


def _lease_conf_overrides() -> Dict:
    from ..core.config import CircuitConfig, LeaseConfig

    return {
        "lease": LeaseConfig(
            fraction=_LEASE_FRACTION, ttl_ms=60_000, max_holders=1,
            reconcile_ms=300, low_water=0.0,
        ),
        # Fast breaker schedule so post-heal half-open probes fit the
        # run budget (the chaos_smoke lease discipline).
        "circuit": CircuitConfig(
            failure_threshold=3, base_backoff_s=0.1,
            max_backoff_s=1.0, jitter=0.2,
        ),
    }


async def _lease_grant(ctx: RunContext) -> None:
    """Acquire a lease grant through a proxy daemon BEFORE the
    partition: the holder must be talking to a non-owner so the cut
    severs holder->owner, not holder->proxy."""
    import time as _t

    from ..client import LeasedClient
    from ..core.types import RateLimitReq, Status

    spec = ctx.spec
    cluster = ctx.cluster
    key = spec.key_name(_LEASE_KEY_IDX)
    hash_key = f"{spec.tenant}_{key}"
    owner = cluster.owner_daemon_of(hash_key)
    proxy = next(d for d in cluster.daemons if d is not owner)
    lc = LeasedClient(
        proxy.grpc_address,
        lease=proxy.conf.lease,
        client_id="gubload-holder",
    )
    req = RateLimitReq(name=spec.tenant, unique_key=key, hits=1,
                       limit=spec.limit, duration=spec.window_ms)
    ctx.state.update(
        lease_client=lc, lease_owner=owner, lease_req=req,
        lease_grant_admitted=0,
    )

    def acquire() -> int:
        admitted = 0
        deadline = _t.monotonic() + 15.0
        while not any(
            v.allowance_left > 0 for v in lc.table._leases.values()
        ):
            rs = lc.get_rate_limits([req])
            admitted += sum(
                1 for r in rs
                if r.error == "" and r.status == Status.UNDER_LIMIT
            )
            if _t.monotonic() > deadline:
                raise AssertionError(
                    f"lease grant never arrived: {lc.stats()}"
                )
            _t.sleep(0.05)
        return admitted

    ctx.state["lease_grant_admitted"] = await asyncio.to_thread(acquire)


async def _lease_partition(ctx: RunContext) -> None:
    """Cut the owner off, then burn the holder's full allowance — and
    prove it can never burn one hit more — while this phase's open-loop
    arrivals keep hammering the partitioned ring."""
    spec = ctx.spec
    owner = ctx.state["lease_owner"]
    lc = ctx.state["lease_client"]
    req = ctx.state["lease_req"]
    allowance = int(spec.limit * _LEASE_FRACTION)
    ctx.injector.set_active(True)
    ctx.injector.partition(
        {owner.grpc_address},
        {d.grpc_address for d in ctx.cluster.daemons if d is not owner},
    )

    def burn() -> int:
        before = lc.stats()["local_admitted"]
        for _ in range(allowance + 20):
            lc.get_rate_limits([req])
        return lc.stats()["local_admitted"] - before

    burned = await asyncio.to_thread(burn)
    assert burned == allowance, (
        f"partition_leased: holder burned {burned}, grant was "
        f"{allowance} — the client-side bound leaked"
    )
    ctx.state["lease_burned"] = burned


async def _lease_heal(ctx: RunContext) -> None:
    ctx.injector.heal()
    lc = ctx.state.pop("lease_client")
    await asyncio.to_thread(lc.close)


def _lease_verdict(ctx: RunContext) -> Dict:
    spec = ctx.spec
    allowance = int(spec.limit * _LEASE_FRACTION)
    t = merged_tenant(ctx.daemons, spec.tenant)
    # One grant landed, so the merged ledger must attribute EXACTLY one
    # allowance of lease-grant over-admission — the live form of
    # limit x (1 + holders x fraction) (docs/leases.md).
    over = t["over_admitted"].get("lease-grant", 0)
    assert over == allowance, (
        f"partition_leased: live lease-grant over-admission {over} != "
        f"allowance {allowance}"
    )
    facts = assert_admission_bound(ctx, extra_allowance=allowance)
    facts["lease_allowance"] = allowance
    facts["lease_burned_under_partition"] = ctx.state["lease_burned"]
    totals = ctx.totals()
    assert totals.errors > 0, (
        "partition_leased: no client-visible errors — the partition "
        "never bit"
    )
    facts.update(assert_reconverged(ctx))
    return facts


PARTITION_LEASED = ScenarioSpec(
    name="partition_leased",
    description="A lease holder is partitioned from its key's owner "
    "mid-run: it burns exactly its allowance and never one hit more; "
    "the merged ledger attributes exactly one lease-grant carve; "
    "breakers re-close after heal.",
    phases=(
        PhaseSpec("grant", 0.25, "steady", "uniform", fault="grant"),
        PhaseSpec("partition", 0.45, "steady", "uniform",
                  fault="partition", profile=True),
        PhaseSpec("heal", 0.3, "steady", "uniform", fault="heal"),
    ),
    limit=200, window_ms=WINDOW_MS, key_universe=24,
    tenant="load.lease", verdict=_lease_verdict,
    hooks={
        "grant": _lease_grant,
        "partition": _lease_partition,
        "heal": _lease_heal,
    },
    needs_cluster=True,
)
# -- region_failover ---------------------------------------------------

_REGION_FRACTION = 0.25


def _region_conf_overrides() -> Dict:
    from ..core.config import CircuitConfig, RegionConfig

    return {
        "region": RegionConfig(
            enabled=True, fraction=_REGION_FRACTION,
            reconcile_ms=200, drift_max=100_000,
        ),
        # Fast breaker schedule so the WAN reconcile arcs re-close
        # inside the heal phase budget.
        "circuit": CircuitConfig(
            failure_threshold=3, base_backoff_s=0.1,
            max_backoff_s=1.0, jitter=0.2,
        ),
    }


async def _region_partition(ctx: RunContext) -> None:
    """Sever the WAN: cut the cluster along its data-center groups.
    Client traffic keeps flowing to BOTH regions — active-active means
    the partition is invisible on the request path (remote-homed keys
    keep serving from their bounded carve; burns queue as drift)."""
    groups: Dict[str, set] = {}
    for d in ctx.cluster.daemons:
        groups.setdefault(d.conf.data_center, set()).add(d.grpc_address)
    assert len(groups) >= 2, f"region_failover needs >= 2 regions: {groups}"
    ctx.injector.set_active(True)
    ctx.injector.partition(*groups.values())
    ctx.state["region_groups"] = groups


async def _region_heal(ctx: RunContext) -> None:
    ctx.injector.heal()


def _region_verdict(ctx: RunContext) -> Dict:
    import time as _t

    spec = ctx.spec
    carve_per_key = int(spec.limit * _REGION_FRACTION)
    keys = spec.key_universe

    # Reconvergence from the region surface first: every daemon's
    # drift drains to zero and every degraded link re-homes through
    # REGION_PREPARE -> TRANSFER -> CUTOVER back to remote.
    deadline = _t.monotonic() + 25.0
    while True:
        vars_ = [d.service.regions.debug_vars() for d in ctx.daemons]
        drained = all(v["drift"] == 0 for v in vars_)
        rehomed = all(
            lk["state"] == "remote"
            for v in vars_ for lk in v["links"].values()
        )
        if drained and rehomed:
            break
        if _t.monotonic() > deadline:
            raise AssertionError(
                f"region_failover: drift never reconverged: {vars_}"
            )
        _t.sleep(0.2)
    dropped = sum(v["reconcile_dropped"] for v in vars_)
    assert dropped == 0, (
        f"region_failover: {dropped} burns dropped as ambiguous — a "
        "clean partition is provably-unsent, nothing may drop"
    )
    rehomes = sum(v["rehomes"] for v in vars_)
    assert rehomes >= 1, (
        f"region_failover: no link ever re-homed after heal: {vars_}"
    )

    totals = ctx.totals()
    # Active-active is the point: a region partition produces ZERO
    # client-visible errors — the request path never crosses the WAN.
    assert totals.errors == 0, (
        f"region_failover: {totals.errors} client-visible errors — "
        "the partition leaked onto the request path"
    )
    # The paper bound on the client surface: per key at most
    # limit x (1 + remote_regions x fraction) unique admissions.
    client_bound = keys * int(spec.limit * (1 + _REGION_FRACTION))
    assert totals.admitted <= client_bound, (
        f"region_failover: client admissions {totals.admitted} > "
        f"bound {client_bound}"
    )

    t = merged_tenant(ctx.daemons, spec.tenant)
    over = t["over_admitted"].get("region-carve", 0)
    assert 0 < over <= carve_per_key * keys, (
        f"region_failover: region-carve over-admission {over} outside "
        f"(0, {carve_per_key} x {keys}] — the carve plane is unbounded "
        "or never served"
    )
    # Ledger allowance: each carve admission counts once at the carve
    # (over-admission) and its reconciled burn may count once more at
    # the home row — hence 2 x the carve budget on top of the base.
    facts = assert_admission_bound(
        ctx, extra_allowance=2 * carve_per_key * keys
    )
    facts.update({
        "region_carve_over": over,
        "region_rehomes": rehomes,
        "region_drift": 0,
        "client_admission_bound": client_bound,
    })
    facts.update(assert_reconverged(ctx))
    return facts


REGION_FAILOVER = ScenarioSpec(
    name="region_failover",
    description="A two-region active-active cluster is cut in half "
    "mid-run: remote-homed keys keep serving from their bounded "
    "region carve with zero client-visible errors, drift reconverges "
    "after heal, every link re-homes, and the merged ledger keeps "
    "region-carve over-admission within fraction x limit per key.",
    phases=(
        PhaseSpec("steady", 0.3, "steady", "uniform"),
        PhaseSpec("partition", 0.4, "steady", "uniform",
                  fault="partition", profile=True),
        PhaseSpec("heal", 0.3, "steady", "uniform", fault="heal"),
    ),
    limit=200, window_ms=WINDOW_MS, key_universe=24,
    tenant="load.region", verdict=_region_verdict,
    hooks={
        "partition": _region_partition,
        "heal": _region_heal,
    },
    needs_cluster=True,
    datacenters=("east", "east", "west", "west"),
)


SCENARIOS = {
    s.name: s
    for s in (STEADY, DIURNAL, BURSTSTORM, FLASHCROWD, RESHARD_CHURN,
              PARTITION_LEASED, REGION_FAILOVER)
}

def _churn_conf_overrides() -> Dict:
    from ..core.config import ReshardConfig

    return {
        "reshard": ReshardConfig(
            handoff_fraction=_LEASE_FRACTION, timeout_s=30.0,
            release_linger_s=2.0,
        ),
    }


# Per-scenario DaemonConfig override factories (runner.py applies them
# over the conf template before boot).
CONF_OVERRIDES = {
    "partition_leased": _lease_conf_overrides,
    "reshard_churn": _churn_conf_overrides,
    "region_failover": _region_conf_overrides,
}


def hot_key_index(spec: ScenarioSpec, schedules) -> int:
    """The most-drawn key index across a run's phase schedules — the
    flash-crowd head (deterministic from the seed)."""
    counts = np.zeros(spec.key_universe, dtype=np.int64)
    for sched in schedules:
        np.add.at(counts, sched.key_idx, 1)
    return int(np.argmax(counts))
