"""stage_ms.sketch.wait: the mean host milliseconds a traced call of the
sketch engine spends in its `sketch.wait` stage: the wait on the merge's own
copy event."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "sketch", "wait")
