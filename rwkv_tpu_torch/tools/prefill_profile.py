"""Prompt ingest on the card: ms per chunk of forward_seq(parallel=True) in
float32 and in bf16 (compute_dtype), the bf16 logits' scaled error against
float32, and each chunk's device time by op (torch.profiler).

    python -m rwkv_tpu_torch.tools.prefill_profile [--chunk 512] [--top 10] [--seed 0]

Standalone it runs RWKV-4 430M widths with random q8 weights from a numpy
seed, laid out as the engine holds a .bin (int8 codes, vocab padded to 512);
chip_smoke.py phase 15 calls prefill_report on the engine's own params.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics

import torch

from rwkv_tpu_torch.models.rwkv4 import forward_seq, init_state

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def median_ms(fn, runs: int = 5) -> float:
    """The median device ms of `runs` calls of fn after one warm-up call,
    each call between two CUDA events."""
    fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, runs: int = 5) -> float:
    """The median ms of `runs` replays of one call of fn captured in a CUDA
    graph: the chunk's time with the host's launches taken out (the engine
    prefills eagerly; this is what a graphed prefill would take)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return median_ms(g.replay, runs)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def ops_by_device_time(fn, top: int = 10):
    """One call of fn under torch.profiler: ([(op, calls, device ms)] for the
    `top` ops by the device time of the kernels each op launched itself, the
    device ms of all ops). Only the ops (aten::mm, aten::mul, ...) are
    counted: the kernels' own rows in the profile repeat the same time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, _device_us(e) / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and _device_us(e) > 0]
    rows.sort(key=lambda r: -r[2])
    return rows[:top], sum(r[2] for r in rows)


def prefill_report(params, T: int = 512, top: int = 10, seed: int = 0) -> dict:
    """One T-token chunk through forward_seq(parallel=True) on the params'
    device, per dtype: {"ms", "tok_s", "ops", "device_ms", "graph_ms"}, and "bf16_err",
    the bf16 logits' scaled error max|bf16 - f32| / max(1, max|f32|) over the
    true vocab."""
    dev = params.device
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, 50277, (T,), generator=g).to(dev)
    state = init_state(params.config, device=dev)
    out, logits = {}, {}
    for name, dt in DTYPES.items():
        def run(dt=dt):
            return forward_seq(params, toks, state, parallel=True, compute_dtype=dt)
        logits[name] = run()[0]
        ms = median_ms(run)
        ops, device_ms = ops_by_device_time(run, top)
        out[name] = {"ms": ms, "tok_s": T / (ms * 1e-3), "ops": ops, "device_ms": device_ms,
                     "graph_ms": graph_ms(run)}
    real = slice(None) if params.logit_bias is None else params.logit_bias == 0
    ref = logits["f32"][real].double()  # the padded columns' -1e9 would scale it away
    out["bf16_err"] = float((logits["bf16"][real].double() - ref).abs().max()
                            / max(1.0, float(ref.abs().max())))
    out["finite"] = all(bool(torch.isfinite(v).all()) for v in logits.values())
    return out


def print_report(rep: dict, T: int, suffix: str = "") -> None:
    for name in DTYPES:
        r = rep[name]
        print(f"  prefill {name}: {r['ms']:.3f} ms per {T}-token chunk (median of 5), "
              f"{r['tok_s']:.1f} tok/s; the ops' device time {r['device_ms']:.3f} ms, "
              f"{r['device_ms'] / r['ms']:.1%} of the chunk's; replayed from a CUDA graph "
              f"{r['graph_ms']:.3f} ms; top {len(r['ops'])} ops {suffix}")
        for op, calls, ms in r["ops"]:
            print(f"    {ms:9.3f} ms {ms / r['device_ms']:6.1%} {calls:6d}x  {op}")
    print(f"  bf16 logits against f32: scaled error {rep['bf16_err']:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prefill_profile: needs a CUDA device")
    from rwkv_tpu_torch.models.config import RWKVConfig
    from rwkv_tpu_torch.models.rwkv4 import (params_to, random_quantized_params_np,
                                             signedize_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    params = params_to(signedize_params(random_quantized_params_np(RWKVConfig.rwkv4_430m(),
                                                                   seed=args.seed)), "cuda")
    print_report(prefill_report(params, args.chunk, args.top, args.seed), args.chunk,
                 f"[{torch.cuda.get_device_name(0)}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
