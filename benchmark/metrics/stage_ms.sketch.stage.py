"""stage_ms.sketch.stage: the mean host milliseconds a traced call of the
sketch engine spends in its `sketch.stage` stage: the three pinned uploads
before K2's launch, and the pinned response buffer, its copy and event after
it."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "sketch", "stage")
