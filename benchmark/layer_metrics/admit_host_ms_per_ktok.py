"""Admission's host time per thousand prompt tokens prefilled: the program's
spans pool.admit (each admitting burst, whole) less pool.admit.read (the
host waiting for the burst's first ids) in the window, over its counter
pool.prefill.tokens."""

from benchmark.program_spans import window_spans


def read(ctx):
    tokens = ctx.counters.get("pool.prefill.tokens", 0)
    spans = window_spans(ctx.window)
    if not tokens or spans is None or not spans["pool.admit"]:
        return None
    return 1e6 * (sum(spans["pool.admit"]) - sum(spans["pool.admit.read"])) / tokens
