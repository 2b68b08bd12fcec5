"""lane_fill.exact: the lanes that carry a request over the lanes the exact
engine ships to K1 (rounds at their batch tier), across the traced calls'
dispatches, in percent, from the counter the program logs with each call's
`exact.pack` stage."""
from benchmark.stages import lane_fill


def read(ctx):
    return lane_fill(ctx, "exact")
