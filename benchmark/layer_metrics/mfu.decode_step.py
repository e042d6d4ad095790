"""The decode steps' share of the card's peak: the least time of every
decode step the pool made in the traced window (its counter pool.steps
times the step chunk, each step over the whole batch; arith.
decode_step_least_s, which names no kernel) over the window's seconds."""

from benchmark import arith


def read(ctx):
    if ctx.trace is None:
        return None
    steps = ctx.counters.get("pool.steps", 0) * ctx.chunk
    if steps == 0:
        return None
    return 100.0 * steps * arith.decode_step_least_s(ctx.cfg, ctx.batch) / ctx.trace.window_s
