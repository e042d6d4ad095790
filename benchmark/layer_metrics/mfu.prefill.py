"""Prompt ingest's share of the float32 peak (67 TFLOP/s outside the tensor
cores, which the configuration's float32 prefill with TF32 off may use):
the products that the prompts admitted in the traced window need (their
tokens as the program's tokenizer counted them, padding not counted;
arith.prefill_flops) over the peak and the window's seconds."""

from benchmark import arith


def read(ctx):
    if ctx.trace is None:
        return None
    win = ctx.window
    admitted = [r for r in win.recs
                if r.t_first is not None and win.t_start < r.t_first <= win.t_end]
    if not admitted:
        return None
    flops = arith.prefill_flops(ctx.cfg, sum(r.prompt_tokens for r in admitted), len(admitted))
    return 100.0 * flops / arith.PEAK_F32_FLOPS / ctx.trace.window_s
