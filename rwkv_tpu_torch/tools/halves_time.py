"""Times of kernel K6 (att_half, ffn_half) and of the "halves" tensor-parallel
step on one GPU, at RWKV-4 430M widths, tp = 1.

    python -m rwkv_tpu_torch.tools.halves_time [--batch 1 8] [--reps 15] [--seed 0]

With random q8 weights from a numpy seed, for each batch size:
  * each half over all L layers in turn, captured once in a CUDA graph and
    replayed `reps` times (CUDA events around each replay, the median), per
    layer: the weights come from device memory, as a step reads them;
  * each half on layer 0 repeated 50 times in one graph, per call: the
    layer's 13.6 MB stay in the 50 MB L2 (the L2-hot figure);
  * the halves step (parallel/tp_step.py, make_tp_step(body="halves") on a
    mesh naming the card once): eager (its body called directly, CUDA events
    around `steps` back-to-back steps), as make_tp_step returns it (the
    engine's path: replayed from its own CUDA graph where it has one), and
    captured whole by the caller in a CUDA graph and replayed (the median).
Prints one JSON line per batch size with the card's name and power limit.
Only att_half/ffn_half's signatures and make_tp_step are used, so a parent
checkout runs it too: PYTHONPATH=<checkout> python <this file>.
"""

from __future__ import annotations

import argparse
import json
import subprocess


def _median(v):
    v = sorted(v)
    return v[len(v) // 2]


def graph_median_ms(fn, calls: int, reps: int) -> float:
    """Device ms per call of fn: `calls` calls captured in one CUDA graph,
    replayed `reps` times, each replay timed with CUDA events; the median."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del g
    return _median(times)


def time_halves(params, B: int, reps: int, gen) -> dict:
    """K6's times at tp = 1 on the unsharded params (which are their own
    tp = 1 shard): per layer over all layers, and on one layer L2-hot."""
    import torch

    from rwkv_tpu_torch.ops.cuda import tp_halves as th

    L, E = params.n_layer, params.n_embd
    dev = params.emb.device
    f = lambda *s: torch.randn(s, device=dev, generator=gen)  # noqa: E731
    x, xy, dd, aa, pp = f(B, E), f(B, E), f(B, E), f(B, E), f(B, E)
    bb = f(B, E).abs() + 0.5
    dl, bl = params.att.decay, params.att.bonus

    def att_all():
        for l in range(L):
            th.att_half(params, l, x, xy, aa, bb, pp, dl, bl)

    def ffn_all():
        for l in range(L):
            th.ffn_half(params, l, x, dd)

    return {
        "att_ms_per_layer": graph_median_ms(att_all, 1, reps) / L,
        "ffn_ms_per_layer": graph_median_ms(ffn_all, 1, reps) / L,
        "att_ms_one_layer_l2_hot": graph_median_ms(
            lambda: th.att_half(params, 0, x, xy, aa, bb, pp, dl, bl), 50, reps),
        "ffn_ms_one_layer_l2_hot": graph_median_ms(lambda: th.ffn_half(params, 0, x, dd), 50,
                                                   reps),
    }


def time_halves_step(params, cfg, B: int, steps: int, reps: int, gen) -> dict:
    """The halves step at tp = 1: eager, as make_tp_step returns it, and
    captured whole by the caller."""
    import torch

    from rwkv_tpu_torch.models.rwkv4 import init_state
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import shard_params
    from rwkv_tpu_torch.parallel.tp_step import make_tp_step

    dev = params.emb.device
    mesh = make_mesh(model=1, devices=[dev])
    sp = shard_params(params, mesh)
    step = make_tp_step(mesh, sp, body="halves")
    eager = getattr(step, "eager", step)
    tok = torch.randint(0, cfg.vocab_size, (B,), device=dev, generator=gen)
    st = init_state(cfg, (B,), device=dev)

    def run(fn):
        s = st
        for _ in range(steps):
            _, s = fn(sp, tok, s)

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def wall(fn):
        run(fn)
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            a.record()
            run(fn)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / steps)
        return _median(times)

    return {"step_eager_ms": wall(eager), "step_ms": wall(step),
            "step_graphed": bool(getattr(step, "graphed", False)),
            "step_caller_graph_ms": graph_median_ms(lambda: eager(sp, tok, st), steps, reps)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import rwkv_tpu_torch
    from rwkv_tpu_torch.models.config import RWKVConfig
    from rwkv_tpu_torch.models.rwkv4 import (
        params_to,
        random_quantized_params_np,
        signedize_params,
    )

    if not torch.cuda.is_available():
        raise SystemExit("halves_time needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = RWKVConfig.rwkv4_430m()
    params = params_to(signedize_params(random_quantized_params_np(cfg, seed=args.seed,
                                                                   pad_multiple=512)), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    for B in args.batch:
        out = {"tree": rwkv_tpu_torch.__file__, "batch": B,
               **time_halves(params, B, args.reps, gen),
               **time_halves_step(params, cfg, B, args.steps, args.reps, gen), "card": card}
        print(json.dumps(out))


if __name__ == "__main__":
    main()
