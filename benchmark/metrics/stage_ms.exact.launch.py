"""stage_ms.exact.launch: the mean host milliseconds a traced call of the
exact engine spends in its `exact.launch` stage: K1's scratch and its bin and
walk launches (persistent_serve_step)."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "exact", "launch")
