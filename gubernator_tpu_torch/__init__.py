"""gubernator_tpu_torch: the PyTorch/CUDA port of gubernator_tpu.

The engine (runtime/backend.TorchBackend) answers exact token- and
leaky-bucket checks against a device-resident W-way set-associative slot
table, applying every round of a check() with one dispatch of a hand-written
CUDA kernel (csrc/serve_kernel.cu) on the card, or its plain PyTorch
version (ops/ring.py) when the caller asks for the CPU.  The approximate
tier (runtime/sketch_backend.SketchBackend) answers its limit names from a
sliding-window count-min sketch, one launch of a second hand-written kernel
(csrc/cms_kernel.cu) per merge, or its plain version (ops/sketch.py) on the
CPU.  A sharded table (DeviceConfig.num_shards > 1) is served by the mesh
backend (parallel/sharded.MeshBackend: the shards are slices of one table,
each served through the same kernel) with its collective GLOBAL engine
(parallel/global_sync.GlobalEngine).  The daemon (daemon.py, `python -m
gubernator_tpu_torch.cli.server`)
serves both over gRPC and HTTP through the compiled fast lane
(runtime/fastpath.py) in every serve mode.  The client SDK (client.py:
V1Client, AsyncV1Client, FastV1Client, LeasedClient) talks to it.  The
engine needs torch and numpy; the daemon's modules and the client add the
wire stack (grpcio, protobuf, aiohttp, prometheus_client, xxhash).  Imports
nothing of JAX or of gubernator_tpu.
"""
from gubernator_tpu_torch.core.types import (  # noqa: F401
    Algorithm,
    Behavior,
    RateLimitReq,
    RateLimitResp,
    Status,
)


def __getattr__(name: str):
    """Lazy top-level client SDK (keeps `import gubernator_tpu_torch` free of
    grpc; the reference's Go package exposes its client the same
    flat way, client.go:42-63)."""
    if name in ("V1Client", "AsyncV1Client"):
        from gubernator_tpu_torch import client

        return getattr(client, name)
    raise AttributeError(name)


def __dir__():
    return sorted(list(globals()) + ["V1Client", "AsyncV1Client"])
