"""stage_ms.global.apply: the mean host milliseconds a traced call of the GLOBAL
engine spends in its `global.apply` stage: the owners' two-round K1 dispatch
on their authoritative shards (the summed hits, then hits = 0) and the
broadcast rows taken from round 1, summed over the sync's chunks. A call's
sync runs at the head of its dispatch and carries its number."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "global", "apply")
