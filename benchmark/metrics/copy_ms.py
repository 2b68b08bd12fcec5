"""copy_ms: device milliseconds of host-to-device and device-to-host
copies a call, from the profiler's trace of the traced calls."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not ctx["trace_calls"] or tr["copy_s"] <= 0:
        return None
    return 1e3 * tr["copy_s"] / ctx["trace_calls"]
