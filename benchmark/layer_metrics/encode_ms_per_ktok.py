"""The program's tokenizer per thousand prompt tokens: its span
pool.submit.encode (InferencePool.submit's encode) summed over the window,
over its counter pool.submit.tokens."""

from benchmark.program_spans import window_spans


def read(ctx):
    tokens = ctx.counters.get("pool.submit.tokens", 0)
    spans = window_spans(ctx.window)
    if not tokens or spans is None or not spans["pool.submit.encode"]:
        return None
    return 1e6 * sum(spans["pool.submit.encode"]) / tokens
