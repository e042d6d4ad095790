"""Padding in admission's prefill (runtime/pool.py InferencePool._admit_batch):
the share of the token lanes computed in the window that held no prompt
token, 100 * (1 - pool.prefill.tokens / pool.prefill.lane_tokens). A burst
of n prompts runs in chunks of prefill_bucket tokens at the next width
bucket >= n, as long as its longest prompt."""


def read(ctx):
    lanes = ctx.counters.get("pool.prefill.lane_tokens", 0)
    if not lanes:
        return None
    return 100.0 * (1.0 - ctx.counters.get("pool.prefill.tokens", 0) / lanes)
