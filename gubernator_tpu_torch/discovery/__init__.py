"""Peer discovery pools (the reference's UpdateFunc callback contract,
config.go:167; wired to V1Instance.SetPeers by the daemon).  The port has
the static pool only; the other kinds are listed in ROADMAP.md."""
from gubernator_tpu_torch.discovery.base import Pool, UpdateFunc  # noqa: F401
from gubernator_tpu_torch.discovery.static import StaticPool  # noqa: F401
