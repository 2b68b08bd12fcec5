"""stage_ms.exact.wait: the mean host milliseconds a traced call of the exact
engine spends in its `exact.wait` stage: the wait on the call's own copy
event."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "exact", "wait")
