"""Generated protobuf modules for the V1 / PeersV1 wire contract.

Regenerate with scripts/protogen.sh.  The wire format is compatible with the
reference service (reference proto/gubernator.proto, proto/peers.proto) so
existing clients interoperate unchanged.
"""
from . import gubernator_pb2, peers_pb2  # noqa: F401
