"""stage_ms.sketch.launch: the mean host milliseconds a traced call of the
sketch engine spends in its `sketch.launch` stage: the host mirror of the
window and K2's roll and walk launches (cms_multi_step)."""
from benchmark.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "sketch", "launch")
