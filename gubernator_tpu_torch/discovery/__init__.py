"""Peer discovery pools.

Each pool watches a membership source and invokes `on_update(peers)` with
the full []PeerInfo whenever it changes (the reference's UpdateFunc
callback contract, config.go:167; wired to V1Instance.SetPeers by the
daemon, daemon.go:188-223).

Available pools:
- StaticPool     — fixed peer list (tests / flat deployments)
- DnsPool        — poll A/AAAA records of an FQDN (dns.go:114-218)
- GossipPool     — UDP gossip membership, the memberlist analog
- K8sPool        — watch Endpoints via the API server (kubernetes.go);
                   gated: needs a kubernetes client in the image
- EtcdPool       — lease-based registration + prefix watch (etcd.go);
                   gated: needs etcd3 in the image
"""
from gubernator_tpu_torch.discovery.base import Pool, UpdateFunc  # noqa: F401
from gubernator_tpu_torch.discovery.static import StaticPool  # noqa: F401
from gubernator_tpu_torch.discovery.dns import DnsPool  # noqa: F401
from gubernator_tpu_torch.discovery.gossip import GossipPool  # noqa: F401
