"""stage_ms.global.broadcast: the mean host milliseconds a traced call of the
GLOBAL engine spends in its `global.broadcast` stage: _all_gather (each
replica's card-to-card carries of every owner's rows) and store_cached_rows on
each replica, summed over the sync's chunks. A call's sync runs at the head of
its dispatch and carries its number."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "global", "broadcast")
