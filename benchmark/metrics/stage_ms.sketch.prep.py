"""stage_ms.sketch.prep: the mean host milliseconds a traced call of the
sketch engine spends in its `sketch.prep` stage: the clips, pads,
concatenations and casts of the merge's columns."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "sketch", "prep")
