"""Declarative scenario specs + ledger-derived verdicts
(docs/loadgen.md).

A scenario is data, not code: an ordered list of phases (each with an
arrival process, key distribution, optional fault hook reusing
testing/chaos.py) plus a verdict function.  The verdict runs AFTER the
last phase and asserts its pass/fail conditions from the merged
/debug/vars ledger the way scripts/chaos_smoke.py does — the live
production surface an operator sees, never test internals — so a
scenario run is a proof artifact: no scenario reports latency without
also proving its admission bound.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class PhaseSpec:
    """One phase of a scenario: `arrivals` (steady/diurnal/burst) at
    `target_rps` peak for `duration_s`, hitting `keys`-distributed
    (uniform/zipf) indexes.  `fault` names a hook from the scenario's
    `hooks` map, awaited at phase entry (chaos injection, partition,
    heal, lease side-channels).  `profile` requests a time-boxed
    torch.profiler capture at this phase's boundary when the run was
    given --profile-dir."""

    name: str
    duration_s: float
    arrivals: str = "steady"
    keys: str = "uniform"
    target_rps: Optional[float] = None   # None: the run's TARGET_RPS
    params: Dict = field(default_factory=dict)
    fault: Optional[str] = None
    profile: bool = False


@dataclass(frozen=True)
class ScenarioSpec:
    """The declarative scenario: phases + the rate limit they drive +
    the ledger verdict.  `verdict(ctx)` raises AssertionError on fail
    and returns a dict of proven facts for the artifact row.
    `hooks[name](ctx)` are async fault hooks; `needs_cluster` marks
    scenarios whose hooks/verdicts require in-process daemons (chaos
    injection / breaker introspection) and cannot drive an external
    address list."""

    name: str
    description: str
    phases: Tuple[PhaseSpec, ...]
    limit: int
    window_ms: int
    key_universe: int
    tenant: str
    verdict: Callable[["RunContext"], Dict]
    hooks: Dict[str, Callable] = field(default_factory=dict)
    needs_cluster: bool = False
    # Per-daemon data-center tags for the booted cluster (empty =
    # `num_daemons` single-region daemons).  Multi-region scenarios
    # (docs/multiregion.md) pin their topology here — the region name
    # IS the data-center tag, so ["east","east","west","west"] boots
    # two two-node regions.
    datacenters: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if not self.phases:
            raise ValueError(f"scenario {self.name!r} has no phases")
        for p in self.phases:
            if p.fault is not None and p.fault not in self.hooks:
                raise ValueError(
                    f"scenario {self.name!r} phase {p.name!r} names "
                    f"unknown fault hook {p.fault!r}"
                )

    def key_name(self, idx: int) -> str:
        return f"{self.name}-k{idx}"


class RunContext:
    """Everything a fault hook or verdict can touch: the in-process
    cluster (None when driving external addresses), the chaos
    injector, the run config, client-observed outcome tallies, and a
    scratch dict hooks use to pass state to the verdict."""

    def __init__(self, spec, cfg, cluster, injector, addresses):
        self.spec = spec
        self.cfg = cfg
        self.cluster = cluster
        self.injector = injector
        self.addresses = list(addresses)
        self.counts_by_phase: Dict[str, object] = {}
        self.state: Dict = {}

    @property
    def daemons(self):
        return [] if self.cluster is None else self.cluster.daemons

    def totals(self):
        from .engine import OutcomeCounts

        total = OutcomeCounts()
        for c in self.counts_by_phase.values():
            total.merge(c)
        return total


# -- the merged /debug/vars ledger (the chaos_smoke idiom) -------------


def merged_tenant(daemons, name: str, extra_scrapes: Dict = None
                  ) -> Dict:
    """The cluster-wide per-tenant ledger, merged from LIVE /debug/vars
    scrapes with gubtop's own merge (docs/observability.md): local
    serves only per node make the sum exact, so over-admission bounds
    are asserted against what an operator actually sees.

    `extra_scrapes`: final scrapes of daemons that have since LEFT the
    cluster (a departed node's tallies are still part of the run's
    accounting — churn hooks capture them right before close)."""
    from ..cli import gubtop

    scrapes = {d.http_address: gubtop.scrape(d.http_address)
               for d in daemons}
    scrapes.update(extra_scrapes or {})
    for t in gubtop._merge_tenants(scrapes, 64):
        if t["name"] == name:
            return t
    raise AssertionError(
        f"tenant {name!r} missing from merged /debug/vars ledgers: "
        f"{[v.get('tenants') for v in scrapes.values()]}"
    )


def assert_admission_bound(ctx: RunContext, extra_allowance: int = 0
                           ) -> Dict:
    """The admission bound every scenario must prove before it may
    report latency: merged-ledger allowed <= limit x keys (+ any
    proven shadow carve), and the ledger accounts for at least every
    client-observed admission.  Scenario windows outlive the run, so
    each key spans at most ONE window and the bound is exact — not a
    rate estimate."""
    spec = ctx.spec
    t = merged_tenant(
        ctx.daemons, spec.tenant,
        extra_scrapes=ctx.state.get("departed_scrapes"),
    )
    totals = ctx.totals()
    bound = spec.limit * spec.key_universe + extra_allowance
    assert t["allowed"] <= bound, (
        f"{spec.name}: ledger over-admission: allowed={t['allowed']} "
        f"> bound {bound} (= {spec.limit} x {spec.key_universe} keys"
        f"{f' + {extra_allowance} carve' if extra_allowance else ''})"
    )
    assert t["allowed"] >= totals.admitted, (
        f"{spec.name}: ledger allowed={t['allowed']} < client-observed "
        f"admissions {totals.admitted} — lost accounting"
    )
    return {
        "ledger_allowed": t["allowed"],
        "ledger_denied": t["denied"],
        "ledger_shed": t.get("shed", 0),
        "client_admitted": totals.admitted,
        "client_denied": totals.denied,
        "client_errors": totals.errors,
        "admission_bound": bound,
    }


def assert_reconverged(ctx: RunContext, probes: int = 8,
                       timeout_s: float = 20.0) -> Dict:
    """Post-heal reconvergence from the production surface: every
    breaker re-closes and a probe round from every daemon serves
    error-free (the chaos_smoke quiesce loop)."""
    import time as _t

    from ..client import V1Client
    from ..core.types import RateLimitReq

    assert ctx.cluster is not None, "reconvergence needs the cluster"
    clients = [V1Client(a) for a in ctx.cluster.addresses()]
    try:
        deadline = _t.monotonic() + timeout_s
        while True:
            clean = True
            for c in clients:
                for r in c.get_rate_limits([
                    RateLimitReq(
                        name=f"{ctx.spec.tenant}.quiesce",
                        unique_key=f"q{i}", hits=1,
                        limit=1_000_000, duration=60_000,
                    )
                    for i in range(probes)
                ], timeout=30):
                    if r.error != "":
                        clean = False
            states = ctx.cluster.breaker_states()
            stuck = [
                (a, pa, s)
                for a, peers in states.items()
                for pa, s in peers.items()
                if s not in ("closed", "disabled")
            ]
            if clean and not stuck:
                return {"reconverged": True, "stuck_breakers": 0}
            if _t.monotonic() > deadline:
                raise AssertionError(
                    f"{ctx.spec.name}: never reconverged after heal: "
                    f"clean={clean} stuck={stuck}"
                )
            _t.sleep(0.1)
    finally:
        for c in clients:
            c.close()
