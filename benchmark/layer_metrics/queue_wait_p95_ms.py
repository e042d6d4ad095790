"""Queue wait: the 95th percentile, over the requests whose admission began
in the window, of the time from joining the pool's queue to that admission
(the stamps t_submit and t_admit on runtime/pool.py's Request)."""

from benchmark.e2e import percentile


def read(ctx):
    win = ctx.window
    waits = []
    for rec in win.recs:
        t_submit = getattr(rec.program, "t_submit", None)
        t_admit = getattr(rec.program, "t_admit", None)
        if t_submit is not None and t_admit is not None and win.t_start <= t_admit <= win.t_end:
            waits.append(t_admit - t_submit)
    if not waits:
        return None
    return 1e3 * percentile(waits, 95)
