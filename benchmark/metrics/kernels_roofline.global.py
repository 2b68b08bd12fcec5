"""kernels_roofline.global: the GLOBAL engine's kernels on every card.  The
least time that the traced calls' useful bytes (global_yardstick: each
call's serve from the replicas and the sync at the head of its dispatch,
each byte read or written once) take at the card's published memory rate,
over the device time, summed over the cards, of every kernel (any name,
copies aside) launched inside the traced calls' dispatch spans, in
percent."""

ENGINE = "global"


def read(ctx):
    tr = ctx["trace"]
    if (ctx["engine"] != ENGINE or not tr or tr["kernel_s"] <= 0
            or not ctx["hbm_bytes_per_s"] or not ctx["traced_bytes"]):
        return None
    least_s = ctx["traced_bytes"] / ctx["hbm_bytes_per_s"]
    return 100.0 * least_s / tr["kernel_s"]
