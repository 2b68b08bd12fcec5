"""lane_fill.global: the lanes that carry a request over the lanes the GLOBAL
engine ships to K1 for its serve (rounds x cards x the widest card's tier),
across the traced calls, in percent, from the counter the program logs with
each call's `global.serve` stage only."""
from benchmark.stages import records


def read(ctx):
    if ctx["engine"] != "global":
        return None
    counts = [r[4] for r in records("global")
              if r[0] == "global.serve" and r[4]]
    shipped = sum(c["lanes"] for c in counts)
    if not shipped:
        return None
    return 100.0 * sum(c["active"] for c in counts) / shipped
