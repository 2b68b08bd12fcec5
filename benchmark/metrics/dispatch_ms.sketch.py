"""dispatch_ms.sketch: the mean host milliseconds of the benchmark's own span
around each dispatch of the sketch engine, over the steady calls of the window
that the profiler did not trace."""

ENGINE, SPANS = "sketch", "dispatch_s"


def read(ctx):
    spans = ctx[SPANS]
    if ctx["engine"] != ENGINE or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
