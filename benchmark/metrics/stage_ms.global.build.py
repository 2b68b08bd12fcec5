"""stage_ms.global.build: the mean host milliseconds a traced call of the GLOBAL
engine spends in its `global.build` stage: _build_chunks, which packs the
queued keys into per-(source, owner) delta grids of delta_slots lanes, chunked
where an owner overflows. A call's sync runs at the head of its dispatch and
carries its number."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "global", "build")
