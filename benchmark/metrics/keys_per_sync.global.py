"""keys_per_sync.global: the keys a sync of the GLOBAL engine packs for their
owners, mean over the traced calls' syncs, from the counter the program logs
with each sync's `global.build` stage only."""
from benchmark.stages import records


def read(ctx):
    if ctx["engine"] != "global":
        return None
    counts = [r[4] for r in records("global")
              if r[0] == "global.build" and r[4]]
    if not counts:
        return None
    return sum(c["keys"] for c in counts) / len(counts)
