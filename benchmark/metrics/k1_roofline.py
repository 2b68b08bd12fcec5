"""k1_roofline: K1, the exact engine's kernels.  The least time that the
traced calls' useful bytes (yardstick.useful_bytes on each call's requests
and answers, padding lanes carrying none) take at the card's published
memory rate, over the device time of every kernel (any name, copies aside)
launched inside the traced calls' dispatch spans, in percent."""

ENGINE = "exact"


def read(ctx):
    tr = ctx["trace"]
    if (ctx["engine"] != ENGINE or not tr or tr["kernel_s"] <= 0
            or not ctx["hbm_bytes_per_s"] or not ctx["traced_bytes"]):
        return None
    least_s = ctx["traced_bytes"] / ctx["hbm_bytes_per_s"]
    return 100.0 * least_s / tr["kernel_s"]
