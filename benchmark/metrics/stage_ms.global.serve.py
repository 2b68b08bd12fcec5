"""stage_ms.global.serve: the mean host milliseconds a traced call of the GLOBAL
engine spends in its `global.serve` stage: serve_packed under the engine's
lock: _ingest (rounds_to_qs, which stacks the call's grid round at the widest
shard's tier, the mesh's per-card uploads and K1's launch on each card's
replica) and _queue."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "global", "serve")
