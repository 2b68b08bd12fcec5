"""stage_ms.sketch.answer: the mean host milliseconds a traced call of the
sketch engine spends in its `sketch.answer` stage: the status, remaining and
reset columns from the responses."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "sketch", "answer")
