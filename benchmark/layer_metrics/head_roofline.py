"""Kernel K2 (csrc/mm8.cu on int8_head.cuh, int8_head_kernel): its least
time at the pool's batch (arith.head_least_s) over its mean device time a
launch in the trace."""

from benchmark import arith, trace


def read(ctx):
    if ctx.trace is None:
        return None
    hit = trace.kernel(ctx.trace, "int8_head_kernel")
    if hit is None or hit[0] == 0:
        return None
    launches, seconds = hit
    return 100.0 * arith.head_least_s(ctx.cfg, ctx.batch) / (seconds / launches)
