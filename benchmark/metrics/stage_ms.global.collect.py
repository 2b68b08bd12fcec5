"""stage_ms.global.collect: the mean host milliseconds a traced call of the
GLOBAL engine spends in its `global.collect` stage: _receive: each owner's
card-to-card carries of its column of every source's grid and the psum merge,
summed over the sync's chunks. A call's sync runs at the head of its dispatch
and carries its number."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "global", "collect")
