"""stage_ms.global.fetch: the mean host milliseconds a traced call of the GLOBAL
engine spends in its `global.fetch` stage: fetch_packed: the wait on the
shards' own copy events and the unpack of the responses to the host."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "global", "fetch")
