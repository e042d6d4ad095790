"""The pool's host time in a step() call that admitted nothing
(runtime/pool.py InferencePool.step): the mean, over such calls in the
traced window, of the call's wall time less the device's busy time inside
it."""


def read(ctx):
    if ctx.trace is None:
        return None
    plain = [wall - busy for admitted, wall, busy in ctx.trace.steps if not admitted]
    if not plain:
        return None
    return 1e3 * sum(plain) / len(plain)
