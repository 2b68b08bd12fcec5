"""dispatch_ms.global: the mean host milliseconds of the benchmark's own span
around each dispatch of the GLOBAL engine (the sync at its head, then the
serve), over the steady calls of the window that the profiler did not
trace."""

ENGINE, SPANS = "global", "dispatch_s"


def read(ctx):
    spans = ctx[SPANS]
    if ctx["engine"] != ENGINE or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
