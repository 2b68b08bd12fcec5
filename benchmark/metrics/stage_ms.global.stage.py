"""stage_ms.global.stage: the mean host milliseconds a traced call of the GLOBAL
engine spends in its `global.stage` stage: _stage, the delta grids' pinned
uploads, one per source card. A call's sync runs at the head of its dispatch
and carries its number."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "global", "stage")
