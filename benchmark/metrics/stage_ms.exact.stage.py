"""stage_ms.exact.stage: the mean host milliseconds a traced call of the exact
engine spends in its `exact.stage` stage: the pinned uploads of the rounds,
clock and sequence word before K1's launch, and the pinned response buffer,
its copy and event after it."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "exact", "stage")
