"""Device geometry of the torch engine, and the sketch tier's settings."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class DeviceConfig:
    """Slot-table geometry and batch shape (no reference analog — replaces
    the Go worker pool's NumCPU/cache-per-worker arithmetic,
    workers.go:127-146).

    The slot table holds `num_slots` rows arranged as `num_slots // ways`
    buckets of `ways` slots; the bucket count must be a power of two.
    `batch_size` is the widest round; a round whose active lanes fit a
    smaller entry of `batch_tiers` (None = (128, batch_size)) ships that
    narrower shape.  `platform` names the torch device type the table lives
    on: None means "cuda"; "cpu" must be asked for explicitly.
    """

    num_slots: int = 65_536
    ways: int = 8
    batch_size: int = 1024
    platform: Optional[str] = None
    batch_tiers: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        if self.num_slots % self.ways != 0:
            raise ValueError(
                "num_slots must be divisible by ways "
                f"(got {self.num_slots}, {self.ways})"
            )
        nb = self.num_slots // self.ways
        if nb & (nb - 1):
            raise ValueError(
                f"num_slots // ways ({nb}) must be a power of two"
            )
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be positive ({self.batch_size})")

    @property
    def device(self) -> str:
        return self.platform or "cuda"


@dataclass
class SketchTierConfig:
    """Approximate (count-min sketch) tier: limit names whose key
    cardinality outgrows exact slots (no reference analog — the reference
    silently over-admits under cache pressure, lrucache.go:147-158).

    SEMANTICS CAVEAT: the sketch counts over tier-level tumbling windows of
    `window_ms` — a request's own `duration` field is IGNORED for names
    routed here (a shared sketch cannot keep per-key windows).  Configure
    `window_ms` to the duration your sketch-tier limits expect; a request
    whose duration differs silently gets window_ms semantics
    (runtime/sketch_backend.py documents the mechanics).

    `use_pallas` is kept so that one config object builds the JAX
    package's tier too; here it changes nothing: on the card the merge
    always runs the hand-written kernel (csrc/cms_kernel.cu), and on the
    CPU its plain version."""

    names: List[str] = field(default_factory=list)
    depth: int = 4
    width: int = 8192  # power of two; error ~ window volume / width
    window_ms: int = 1000
    batch_size: int = 1024
    use_pallas: bool = False
    # Dynamic spillover: when set, a name whose EXACT-tier pressure
    # crosses a threshold is routed to this sketch tier from then on
    # (approximate answers, metadata tier=sketch), so a cardinality bomb on
    # one name degrades that name instead of squeezing every name's
    # slot-table residency.  Either knob arms the mode:
    #   spill_inserts    — estimated DISTINCT keys for the name (a
    #                      per-name HyperLogLog over insert-lane key
    #                      fingerprints, ~±13%; expiry/re-insert churn
    #                      of a small healthy key set does NOT
    #                      accumulate)
    #   spill_transients — cumulative lanes denied a slot under
    #                      full-bucket pressure (zero for a healthy
    #                      table; the unexpired_evictions signal)
    spill_inserts: Optional[int] = None
    spill_transients: Optional[int] = None
