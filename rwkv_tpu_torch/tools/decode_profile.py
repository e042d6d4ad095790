"""Where a decode step's time goes on the GPU, at RWKV-4 430M widths.

    python -m rwkv_tpu_torch.tools.decode_profile [--quant q8|q4] [--batch 1 8] [--steps 30]
                                                  [--seed 0]

For each batch size, with random q8 or packed q4 weights from a numpy seed
(q4: the default pairing block), it measures:
  * wall ms per step of forward_step_fused (CUDA events around `steps`
    back-to-back steps: what a caller that does not read the logits sees);
  * host ms per step: the time the Python + C host code takes to enqueue a
    step (no synchronisation), which bounds the wall time from below when
    the launches, not the kernels, are the limit;
  * device ms per step by kernel (torch.profiler, CUDA activity), and the
    device's busy share of the wall time;
  * device ms per step by launch position: the step's rwkv kernels in the
    order decode_stack.cu launches them (per layer: ln1+mix, k/v/r + WKV,
    output, ln2+mix, key, value+gate; then ln_out and the mm8 or mm4 head);
  * graph ms per step: the same step captured once in a CUDA graph and
    replayed, which takes the host's launch cost out of the wall time;
  * sampled ms per token: the engine's generate loop without the tokenizer
    (step, typical sampling, then the host reads the ids, every token), by
    the host clock, and the device's busy share of that loop;
  * at B=1, engine ms per token: RWKV.generate itself on the same weights
    after a short prompt, by the host clock, with the device's busy share
    and the host operations that took the most time (torch.profiler).
Prints one JSON line per batch size. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict


PHASES = ("ln1+mix", "k/v/r+wkv", "output", "ln2+mix", "key", "value+gate")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quant", choices=["q8", "q4"], default="q8")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rwkv_tpu_torch.models.config import RWKVConfig
    from rwkv_tpu_torch.models.rwkv4 import (
        init_state,
        params_to,
        random_quantized_params_np,
        signedize_params,
    )
    from rwkv_tpu_torch.ops.cuda.decode_stack import forward_step_fused
    from rwkv_tpu_torch.ops.sampling import typical
    from rwkv_tpu_torch.runtime.engine import RWKV

    if not torch.cuda.is_available():
        raise SystemExit("decode_profile needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = RWKVConfig.rwkv4_430m()
    host = random_quantized_params_np(cfg, seed=args.seed, q4=args.quant == "q4")
    params = params_to(signedize_params(host), dev)
    head = "head (mm4)" if args.quant == "q4" else "head (mm8)"
    rng = np.random.default_rng(args.seed)

    for B in args.batch:
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        st = init_state(cfg, (B,), device=dev)

        def run(n):
            s = st
            for _ in range(n):
                _, s = forward_step_fused(params, tok, s)
            return s

        run(3)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        run(args.steps)
        host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        b.record()
        b.synchronize()
        wall_ms = a.elapsed_time(b) / args.steps

        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run(args.steps)
        graph.replay()
        torch.cuda.synchronize()
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        graph_ms = a.elapsed_time(b) / args.steps
        del graph

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(args.steps)
            torch.cuda.synchronize()
        by_kernel = defaultdict(float)
        for evt in prof.key_averages():
            us = _device_us(evt)
            if us > 0 and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
                by_kernel[evt.key] += us / 1e3 / args.steps
        device_ms = sum(by_kernel.values())
        ours = sorted((e for e in prof.events()
                       if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                       and "rwkv::" in e.name), key=lambda e: e.time_range.start)
        per_step = 6 * cfg.n_layer + 2
        by_position = defaultdict(float)
        for i, e in enumerate(ours):
            j = i % per_step
            label = (PHASES[j % 6] if j < 6 * cfg.n_layer
                     else ("ln_out" if j == 6 * cfg.n_layer else head))
            by_position[label] += e.time_range.elapsed_us() / 1e3 / args.steps
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)

        def sampled(n):
            t, s = tok, st
            for _ in range(n):
                logits, s = forward_step_fused(params, t, s)
                t = typical(logits, gen)
                t.tolist()  # the host read generate() makes per token

        sampled(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampled(args.steps)
        sampled_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_s:
            t0 = time.perf_counter()
            sampled(args.steps)
            traced_ms = (time.perf_counter() - t0) * 1e3
        sampled_busy = sum(_device_us(e) for e in prof_s.key_averages()
                           if getattr(e, "device_type", None)
                           == torch.autograd.DeviceType.CUDA) / 1e3 / traced_ms

        engine = {}
        if B == 1:
            eng = RWKV(device=dev)
            eng.load_params(host)
            eng.load_tokenizer()

            def request():
                eng.reset_state()
                eng.load_context("In a hole in the ground there lived a hobbit.")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.generate("", max_tokens=args.steps, seed=args.seed)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

            request()
            engine_ms = request()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_e:
                traced_ms = request()
            evts = prof_e.key_averages()
            busy = sum(_device_us(e) for e in evts if getattr(e, "device_type", None)
                       == torch.autograd.DeviceType.CUDA) / 1e3
            top = sorted(((e.key, e.self_cpu_time_total / 1e3 / args.steps) for e in evts
                           if getattr(e, "device_type", None)
                           == torch.autograd.DeviceType.CPU), key=lambda kv: -kv[1])[:8]
            engine = {"engine_ms_per_token": engine_ms / args.steps,
                      "engine_device_busy_share": busy / traced_ms,
                      "engine_host_ms_per_token_by_op": dict(top)}
            del eng

        out = {"quant": args.quant, "batch": B, "wall_ms_per_step": wall_ms, "host_enqueue_ms_per_step": host_ms,
               "graph_ms_per_step": graph_ms,
               "sampled_ms_per_token": sampled_ms,
               "sampled_device_busy_share": sampled_busy,
               "device_ms_per_step": device_ms,
               "device_busy_share": device_ms / wall_ms if wall_ms else None,
               "device_ms_per_step_by_kernel": dict(sorted(by_kernel.items(),
                                                           key=lambda kv: -kv[1])),
               "device_ms_per_step_by_launch": dict(by_position),
               "rwkv_kernels_seen": len(ours),
               **engine,
               "card": card}
        print(json.dumps(out))


if __name__ == "__main__":
    main()
