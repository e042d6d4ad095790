"""Kernel K1 (csrc/decode_stack.cu, decode_stack_kernel): its least time at
the pool's batch (arith.stack_least_s: the layers' bytes over the HBM peak
or their products over the bf16 tensor cores' peak, whichever is longer)
over its mean device time a launch in the trace."""

from benchmark import arith, trace


def read(ctx):
    if ctx.trace is None:
        return None
    hit = trace.kernel(ctx.trace, "decode_stack_kernel")
    if hit is None or hit[0] == 0:
        return None
    launches, seconds = hit
    return 100.0 * arith.stack_least_s(ctx.cfg, ctx.batch) / (seconds / launches)
