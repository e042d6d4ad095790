"""Time the int8 matvec of csrc/qmv.cuh alone, through the mm8 entry point,
at the layer shapes of a decode step, for several contraction splits.

    python -m rwkv_tpu_torch.tools.qmv_probe [--batch 1] [--iters 200]

For each shape [B, K] x [K, O] and each target block count (which sets the
split S of the contraction across blocks, csrc/qmv.cuh:qmv_split), prints
the kernel's device us per launch and the GB/s of weight bytes. The launches
are captured once in a CUDA graph and replayed, so the host's cost per launch
(several us through Python and ctypes) does not hide the device time. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()

    import torch

    from rwkv_tpu_torch.ops.cuda import _build
    from rwkv_tpu_torch.ops.cuda import mm8 as mm8_mod

    if not torch.cuda.is_available():
        raise SystemExit("qmv_probe needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    lib = mm8_mod._kernel()
    partial, counters, _ = _build.split_scratch(dev, "qmv_probe")
    g = torch.Generator(device=dev).manual_seed(0)
    B = args.batch
    for K, O in ((32, 16), (1024, 1024), (1024, 4096), (4096, 1024), (1024, 50688)):
        xs = torch.randn((B, K), generator=g, device=dev)
        w = torch.randint(-128, 128, (K, O), generator=g, device=dev, dtype=torch.int8)
        out = torch.empty((B, O), device=dev)
        row = {"B": B, "K": K, "O": O, "card": card}
        for target in (1, 66, 132, 264, 528, 1056):
            def launch():
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = lib.rwkv_mm8(xs.data_ptr(), w.data_ptr(), out.data_ptr(), None, None, B, K,
                                   O, partial.data_ptr(), partial.numel(), counters.data_ptr(),
                                   counters.numel(), target, stream)
                _build.check(lib, err, "qmv_probe")

            for _ in range(3):
                launch()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(args.iters):
                    launch()
            graph.replay()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            us = a.elapsed_time(b) * 1e3 / args.iters
            ref = xs.double() @ w.double()
            ok = float((out.double() - ref).abs().max() / ref.abs().max()) < 1e-5
            row[f"target{target}"] = {"us": round(us, 3), "GBps": round(K * O / us / 1e3, 1),
                                      "ok": ok}
        print(json.dumps(row))


if __name__ == "__main__":
    main()
