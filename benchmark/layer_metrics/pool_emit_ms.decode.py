"""The pool's per-token bookkeeping a decode chunk (InferencePool.step: each
slot's ids detokenized, the stop scan, finished requests closed): the mean
of its span pool.decode.emit over the window's decode chunks."""

from benchmark.program_spans import window_spans


def read(ctx):
    spans = window_spans(ctx.window)
    if spans is None or not spans["pool.decode.emit"]:
        return None
    emit = spans["pool.decode.emit"]
    return 1e3 * sum(emit) / len(emit)
