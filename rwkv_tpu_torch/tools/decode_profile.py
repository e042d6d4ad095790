"""Where a decode step's time goes on the GPU, at RWKV-4 430M widths.

    python -m rwkv_tpu_torch.tools.decode_profile [--batch 1 8] [--steps 30] [--seed 0]

For each batch size, with random weights from a numpy seed, it measures:
  * wall ms per step of forward_step_fused (CUDA events around `steps`
    back-to-back steps: what a caller that does not read the logits sees);
  * host ms per step: the time the Python + C host code takes to enqueue a
    step (no synchronisation), which bounds the wall time from below when
    the launches, not the kernels, are the limit;
  * device ms per step by kernel (torch.profiler, CUDA activity), and the
    device's busy share of the wall time;
  * device ms per step by launch position: the step's rwkv kernels in the
    order decode_stack.cu launches them (per layer: ln1+mix, k/v/r + WKV,
    output, ln2+mix, key, value+gate; then ln_out and the mm8 head);
  * graph ms per step: the same step captured once in a CUDA graph and
    replayed, which takes the host's launch cost out of the wall time.
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

    if not torch.cuda.is_available():
        raise SystemExit("decode_profile needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = RWKVConfig.rwkv4_430m()
    params = params_to(signedize_params(random_quantized_params_np(cfg, seed=args.seed)), dev)
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
                     else ("ln_out" if j == 6 * cfg.n_layer else "head (mm8)"))
            by_position[label] += e.time_range.elapsed_us() / 1e3 / args.steps
        out = {"batch": B, "wall_ms_per_step": wall_ms, "host_enqueue_ms_per_step": host_ms,
               "graph_ms_per_step": graph_ms,
               "device_ms_per_step": device_ms,
               "device_busy_share": device_ms / wall_ms if wall_ms else None,
               "device_ms_per_step_by_kernel": dict(sorted(by_kernel.items(),
                                                           key=lambda kv: -kv[1])),
               "device_ms_per_step_by_launch": dict(by_position),
               "rwkv_kernels_seen": len(ours),
               "card": card}
        print(json.dumps(out))


if __name__ == "__main__":
    main()
