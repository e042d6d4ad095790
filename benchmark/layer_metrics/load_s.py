"""Set-up: seconds to make the weights on the device from the seed and hand
them to the engine (RWKV(...).load_params, its tokenizer and the pool)."""


def read(ctx):
    return ctx.setup.get("load_s")
