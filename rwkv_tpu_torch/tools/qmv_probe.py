"""Time the grid barrier of the persistent decode stack (csrc/grid.cuh).

    python -m rwkv_tpu_torch.tools.qmv_probe [--batch 1] [--iters 200]

Launches a cooperative kernel at the grid the decode stack uses at this
batch and 430M width (csrc/decode_stack.cu: the occupancy API's blocks per
SM times the SMs) that runs N grid barriers and nothing else, for N in 0, 1,
97 and 1000, and prints us per launch and us per barrier ((t(N) - t(0)) /
N), beside a near-empty int8 head launch ([B, 32] x [32, 16], K2).

The launches are captured once in a CUDA graph and replayed, so the host's
cost per launch (several us through Python and ctypes) does not hide the
device time. Needs a CUDA device.
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

    from rwkv_tpu_torch.ops.cuda import decode_stack as ds_mod
    from rwkv_tpu_torch.ops.cuda import mm8 as mm8_mod

    if not torch.cuda.is_available():
        raise SystemExit("qmv_probe needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    B = args.batch

    def graph_us(launch) -> float:
        """Device us per call of launch(), args.iters calls in one graph."""
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
        return a.elapsed_time(b) * 1e3 / args.iters

    word = torch.zeros(64, dtype=torch.int32, device=dev)
    xs = torch.randn((B, 32), generator=g, device=dev)
    w = torch.randint(-128, 128, (32, 16), generator=g, device=dev, dtype=torch.int8)
    row = {"B": B, "empty_matvec_us": round(graph_us(lambda: mm8_mod.mm8(xs, w)), 3),
           "card": card}
    for fmt, kw in (("q8", {}), ("q4", {"q4": True}), ("a8", {"a8": True})):
        grid = ds_mod.stack_grid(B, 1024, **kw)
        us = {n: graph_us(lambda n=n: ds_mod.barrier_probe(grid, n, word))
              for n in (0, 1, 97, 1000)}
        row[fmt] = {"grid": grid, **{f"launch_us_n{n}": round(t, 3) for n, t in us.items()},
                    "us_per_barrier": round((us[1000] - us[0]) / 1000, 4),
                    "us_per_barrier_n97": round((us[97] - us[0]) / 97, 4)}
    print(json.dumps(row))


if __name__ == "__main__":
    main()
