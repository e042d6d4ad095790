"""Set-up: seconds to warm the cell's own shapes (admission's prefill at
every burst width, its first-token sampling) and run the closed loop's
first steps, which capture the pool's CUDA graph."""


def read(ctx):
    return ctx.setup.get("warm_s")
