"""decisions_per_s: every decision the window's calls returned to the host,
over the whole window (its drain included)."""


def read(ctx):
    if not ctx["decisions"]:
        return None
    return ctx["decisions"] / ctx["window_s"]
