"""stage_ms.exact.pack: the mean host milliseconds a traced call of the exact
engine spends in its `exact.pack` stage: rounds_to_qs, which stacks the call's
rounds at their tier, and the rounds' clock column."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "exact", "pack")
