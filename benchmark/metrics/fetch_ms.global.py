"""fetch_ms.global: the mean host milliseconds of the benchmark's own span
around each fetch of the GLOBAL engine (the responses to the host and each
check's answer), over the steady calls of the window that the profiler did
not trace."""

ENGINE, SPANS = "global", "fetch_s"


def read(ctx):
    spans = ctx[SPANS]
    if ctx["engine"] != ENGINE or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
