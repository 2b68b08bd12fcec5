"""stage_ms.exact.tally: the mean host milliseconds a traced call of the exact
engine spends in its `exact.tally` stage: the per-round views of the
responses, the tally, the metrics' counters and the flight recorder."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "exact", "tally")
