"""Share of the traced window in which no operation ran on the device, in
the cells where decoding does most of the work (torch.profiler's CUDA
activity, union of every kernel, copy and set)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
