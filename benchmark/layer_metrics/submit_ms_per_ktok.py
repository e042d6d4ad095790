"""Host time of InferencePool.submit (the program's tokenizer encoding the
prompt, and the queueing) per thousand prompt tokens, over every submit()
call in the window (the harness's spans around it)."""


def read(ctx):
    win = ctx.window
    inside = [(t1 - t0, n) for t0, t1, n in win.submits if win.t_start <= t0 < win.t_end]
    tokens = sum(n for _, n in inside)
    if tokens == 0:
        return None
    return 1e6 * sum(s for s, _ in inside) / tokens
