"""output_tokens_per_s (e2e.py), read from the traced run, for the cells where its
untraced runs spread too widely for an end-to-end bound (the host's admission sets
it; PERF.md section 2). The profiler slows the host's launches, so it reads lower
than an untraced run would."""

from benchmark import e2e


def read(ctx):
    return e2e.output_tokens_per_s(ctx.window)
