"""stream_gap_p95_ms (e2e.py), read from the traced run, for the cells where its
untraced runs spread too widely for an end-to-end bound (the host's admission sets
it; PERF.md section 2). The profiler slows the host's launches, so it reads higher
than an untraced run would."""

from benchmark import e2e


def read(ctx):
    if not e2e.stream_gaps(ctx.window):
        return None
    return e2e.stream_gap_p95_ms(ctx.window)
