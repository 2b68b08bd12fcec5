"""gRPC wiring for the V1 / PeersV1 services: codecs, stubs, handlers.

grpc_python_plugin is unavailable in this image, so instead of generated
`*_pb2_grpc.py` stubs this module hand-wires the two services against grpc's
generic-handler API.  Method paths and message encoding are wire-compatible
with the reference services (reference proto/gubernator.proto:27-45,
proto/peers.proto:28-34), verified by tests/test_wire.py.

Also holds the pb2 <-> dataclass codecs used by the service, peer client and
client SDK.
"""
from __future__ import annotations

from typing import List

import grpc

from gubernator_tpu_torch.core.types import (
    Algorithm,
    Behavior,
    HealthCheckResp,
    LeaseGrant,
    RateLimitReq,
    RateLimitResp,
    ReconcileItem,
    Status,
    UpdatePeerGlobal,
)
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.proto import peers_pb2 as peers_pb

V1_SERVICE = "pb.gubernator.V1"
PEERS_SERVICE = "pb.gubernator.PeersV1"


# --------------------------------------------------------------------------
# dataclass <-> pb2 codecs
# --------------------------------------------------------------------------

def req_to_pb(r: RateLimitReq) -> pb.RateLimitReq:
    return pb.RateLimitReq(
        name=r.name,
        unique_key=r.unique_key,
        hits=int(r.hits),
        limit=int(r.limit),
        duration=int(r.duration),
        algorithm=int(r.algorithm),
        behavior=int(r.behavior),
        burst=int(r.burst),
    )


def req_from_pb(m: pb.RateLimitReq) -> RateLimitReq:
    return RateLimitReq(
        name=m.name,
        unique_key=m.unique_key,
        hits=m.hits,
        limit=m.limit,
        duration=m.duration,
        algorithm=Algorithm(m.algorithm),
        behavior=Behavior(m.behavior),
        burst=m.burst,
    )


def resp_to_pb(r: RateLimitResp) -> pb.RateLimitResp:
    m = pb.RateLimitResp(
        status=int(r.status),
        limit=int(r.limit),
        remaining=int(r.remaining),
        reset_time=int(r.reset_time),
        error=r.error,
    )
    for k, v in r.metadata.items():
        m.metadata[k] = v
    return m


def resp_from_pb(m: pb.RateLimitResp) -> RateLimitResp:
    return RateLimitResp(
        status=Status(m.status),
        limit=m.limit,
        remaining=m.remaining,
        reset_time=m.reset_time,
        error=m.error,
        metadata=dict(m.metadata),
    )


def health_to_pb(h: HealthCheckResp) -> pb.HealthCheckResp:
    return pb.HealthCheckResp(
        status=h.status, message=h.message, peer_count=h.peer_count
    )


def health_from_pb(m: pb.HealthCheckResp) -> HealthCheckResp:
    return HealthCheckResp(
        status=m.status, message=m.message, peer_count=m.peer_count
    )


def global_to_pb(g: UpdatePeerGlobal) -> peers_pb.UpdatePeerGlobal:
    m = peers_pb.UpdatePeerGlobal(key=g.key, algorithm=int(g.algorithm))
    if g.status is not None:
        m.status.CopyFrom(resp_to_pb(g.status))
    return m


def global_from_pb(m: peers_pb.UpdatePeerGlobal) -> UpdatePeerGlobal:
    return UpdatePeerGlobal(
        key=m.key,
        status=resp_from_pb(m.status),
        algorithm=Algorithm(m.algorithm),
    )


def lease_grant_to_pb(g: LeaseGrant) -> peers_pb.LeaseGrant:
    return peers_pb.LeaseGrant(
        key=g.key,
        allowance=int(g.allowance),
        expires_at=int(g.expires_at),
        reset_time=int(g.reset_time),
        limit=int(g.limit),
        refusal=g.refusal,
    )


def lease_grant_from_pb(m: peers_pb.LeaseGrant) -> LeaseGrant:
    return LeaseGrant(
        key=m.key,
        allowance=m.allowance,
        expires_at=m.expires_at,
        reset_time=m.reset_time,
        limit=m.limit,
        refusal=m.refusal,
    )


def reconcile_item_to_pb(it: ReconcileItem) -> peers_pb.ReconcileItem:
    return peers_pb.ReconcileItem(
        request=req_to_pb(it.request),
        release=it.release,
        renew=it.renew,
    )


def reconcile_item_from_pb(m: peers_pb.ReconcileItem) -> ReconcileItem:
    return ReconcileItem(
        request=req_from_pb(m.request),
        release=m.release,
        renew=m.renew,
    )


def reqs_from_pb(ms) -> List[RateLimitReq]:
    return [req_from_pb(m) for m in ms]


def resps_to_pb(rs) -> List[pb.RateLimitResp]:
    return [resp_to_pb(r) for r in rs]


# --------------------------------------------------------------------------
# Client stubs (work on both grpc and grpc.aio channels)
# --------------------------------------------------------------------------

class V1Stub:
    """Client stub for the V1 service (GetRateLimits / HealthCheck)."""

    def __init__(self, channel) -> None:
        self.GetRateLimits = channel.unary_unary(
            f"/{V1_SERVICE}/GetRateLimits",
            request_serializer=pb.GetRateLimitsReq.SerializeToString,
            response_deserializer=pb.GetRateLimitsResp.FromString,
        )
        self.HealthCheck = channel.unary_unary(
            f"/{V1_SERVICE}/HealthCheck",
            request_serializer=pb.HealthCheckReq.SerializeToString,
            response_deserializer=pb.HealthCheckResp.FromString,
        )


class PeersV1Stub:
    """Client stub for the PeersV1 service (peer forwards + GLOBal pushes)."""

    def __init__(self, channel) -> None:
        self.GetPeerRateLimits = channel.unary_unary(
            f"/{PEERS_SERVICE}/GetPeerRateLimits",
            request_serializer=peers_pb.GetPeerRateLimitsReq.SerializeToString,
            response_deserializer=peers_pb.GetPeerRateLimitsResp.FromString,
        )
        self.UpdatePeerGlobals = channel.unary_unary(
            f"/{PEERS_SERVICE}/UpdatePeerGlobals",
            request_serializer=peers_pb.UpdatePeerGlobalsReq.SerializeToString,
            response_deserializer=peers_pb.UpdatePeerGlobalsResp.FromString,
        )
        self.Lease = channel.unary_unary(
            f"/{PEERS_SERVICE}/Lease",
            request_serializer=peers_pb.LeaseReq.SerializeToString,
            response_deserializer=peers_pb.LeaseResp.FromString,
        )
        self.Reconcile = channel.unary_unary(
            f"/{PEERS_SERVICE}/Reconcile",
            request_serializer=peers_pb.ReconcileReq.SerializeToString,
            response_deserializer=peers_pb.ReconcileResp.FromString,
        )
        self.Handoff = channel.unary_unary(
            f"/{PEERS_SERVICE}/Handoff",
            request_serializer=peers_pb.HandoffReq.SerializeToString,
            response_deserializer=peers_pb.HandoffResp.FromString,
        )
        self.Migrate = channel.unary_unary(
            f"/{PEERS_SERVICE}/Migrate",
            request_serializer=peers_pb.MigrateReq.SerializeToString,
            response_deserializer=peers_pb.MigrateResp.FromString,
        )


# --------------------------------------------------------------------------
# Server handler registration
# --------------------------------------------------------------------------

def v1_generic_handler(servicer, raw: bool = False) -> grpc.GenericRpcHandler:
    """Build the V1 generic handler for `servicer`, which must expose
    async (or sync, for a sync server) methods GetRateLimits(req, context)
    and HealthCheck(req, context) operating on pb2 messages.

    With raw=True, GetRateLimits receives the undeserialized payload bytes
    and must return response bytes — the daemon's compiled fast lane
    (runtime/fastpath.py) parses/serializes the wire format in C++ and a
    python-protobuf round-trip here would throw that win away."""
    rpc = grpc.unary_unary_rpc_method_handler
    return grpc.method_handlers_generic_handler(V1_SERVICE, {
        "GetRateLimits": rpc(
            servicer.GetRateLimits,
            request_deserializer=(
                None if raw else pb.GetRateLimitsReq.FromString
            ),
            response_serializer=(
                None if raw else pb.GetRateLimitsResp.SerializeToString
            ),
        ),
        "HealthCheck": rpc(
            servicer.HealthCheck,
            request_deserializer=pb.HealthCheckReq.FromString,
            response_serializer=pb.HealthCheckResp.SerializeToString,
        ),
    })


def peers_generic_handler(
    servicer, raw: bool = False
) -> grpc.GenericRpcHandler:
    """Build the PeersV1 generic handler for `servicer` (GetPeerRateLimits /
    UpdatePeerGlobals over pb2 messages; raw=True passes GetPeerRateLimits
    payload bytes through for the compiled fast lane)."""
    rpc = grpc.unary_unary_rpc_method_handler
    handlers = {
        "GetPeerRateLimits": rpc(
            servicer.GetPeerRateLimits,
            request_deserializer=(
                None if raw else peers_pb.GetPeerRateLimitsReq.FromString
            ),
            response_serializer=(
                None if raw
                else peers_pb.GetPeerRateLimitsResp.SerializeToString
            ),
        ),
        "UpdatePeerGlobals": rpc(
            servicer.UpdatePeerGlobals,
            request_deserializer=peers_pb.UpdatePeerGlobalsReq.FromString,
            response_serializer=peers_pb.UpdatePeerGlobalsResp.SerializeToString,
        ),
    }
    # Client-side admission leases (docs/leases.md) — low-rate control
    # RPCs, so the python-protobuf round trip is fine here (the zero-RPC
    # local burn is where the hot path lives).  Optional on the servicer:
    # test doubles that only speak the forward/broadcast pair still
    # build a handler, and callers hitting Lease on them get UNIMPLEMENTED
    # from grpc itself.
    if hasattr(servicer, "Lease"):
        handlers["Lease"] = rpc(
            servicer.Lease,
            request_deserializer=peers_pb.LeaseReq.FromString,
            response_serializer=peers_pb.LeaseResp.SerializeToString,
        )
    if hasattr(servicer, "Reconcile"):
        handlers["Reconcile"] = rpc(
            servicer.Reconcile,
            request_deserializer=peers_pb.ReconcileReq.FromString,
            response_serializer=peers_pb.ReconcileResp.SerializeToString,
        )
    # Live resharding (docs/resharding.md) — control-plane RPCs, so
    # python protobuf is fine (Migrate chunks are seconds-scale bulk
    # transfer, not the check path).  Optional like Lease/Reconcile.
    if hasattr(servicer, "Handoff"):
        handlers["Handoff"] = rpc(
            servicer.Handoff,
            request_deserializer=peers_pb.HandoffReq.FromString,
            response_serializer=peers_pb.HandoffResp.SerializeToString,
        )
    if hasattr(servicer, "Migrate"):
        handlers["Migrate"] = rpc(
            servicer.Migrate,
            request_deserializer=peers_pb.MigrateReq.FromString,
            response_serializer=peers_pb.MigrateResp.SerializeToString,
        )
    return grpc.method_handlers_generic_handler(PEERS_SERVICE, handlers)
