"""Device geometry of the torch engine."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


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
