"""Times of the decode heads, kernels K2 (mm8), K3 (mm4) and K5's head
(mm8_a8), on one GPU at the RWKV-4 430M head shape: [B, 1024] x [1024, 50688].

    python -m rwkv_tpu_torch.tools.head_time [--heads mm4 mm8 mm8_a8 mm8_a8_amax]
                                             [--batch 1 8 16] [--reps 15] [--seed 0]

mm8_a8_amax is K5's head given the row maxima, as the a8 decode step calls
it (the decode stack's ln_out kernel writes them); mm8_a8 finds its own.

For each head and batch size, with random weights from a numpy seed, the
median of `reps` replays of one CUDA graph of many calls, CUDA events around
each replay, per call:
  * warm: every call on one weight (26 MB packed q4 stays in the 50 MB L2;
    the 52 MB int8 weight does not all fit);
  * from HBM: the calls rotate over copies of the weight, one copy a call,
    at least 4 copies and 150 MB, more than the L2 holds: what the head
    finds in a decode step, after the layers' weights.
Prints one JSON line per head and batch size with the card's name and power
limit. Only mm8, mm4 and mm8_a8's signatures are used, so a parent checkout
runs it too: PYTHONPATH=<checkout> python <this file>.
"""

from __future__ import annotations

import argparse
import json
import subprocess

COLD_BYTES = 150e6  # the copies of a weight that one rotation reads: 3x the L2


def cold_median_ms(fn, operands, calls: int, reps: int) -> float:
    """Device ms per call of fn(operand), the calls cycling through
    `operands` one a call, captured in one CUDA graph and replayed `reps`
    times; the median (halves_time.graph_median_ms)."""
    from rwkv_tpu_torch.tools.halves_time import graph_median_ms

    turn = [0]

    def call():
        fn(operands[turn[0] % len(operands)])
        turn[0] += 1

    return graph_median_ms(call, calls, reps)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heads", nargs="+", default=["mm4", "mm8", "mm8_a8"],
                    choices=["mm4", "mm8", "mm8_a8", "mm8_a8_amax"])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8, 16])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    import rwkv_tpu_torch
    from rwkv_tpu_torch.ops.cuda import mm4 as mm4_mod
    from rwkv_tpu_torch.ops.cuda import mm8 as mm8_mod
    from rwkv_tpu_torch.tools.halves_time import graph_median_ms

    if not torch.cuda.is_available():
        raise SystemExit("head_time needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    K, O = 1024, 50688
    heads = {"mm4": (lambda xs, w, amax: mm4_mod.mm4(xs, w), (K // 2, O)),
             "mm8": (lambda xs, w, amax: mm8_mod.mm8(xs, w), (K, O)),
             "mm8_a8": (lambda xs, w, amax: mm8_mod.mm8_a8(xs, w), (K, O)),
             "mm8_a8_amax": (lambda xs, w, amax: mm8_mod.mm8_a8(xs, w, amax=amax), (K, O))}
    for name in args.heads:
        fn, shape = heads[name]
        n = max(4, -(-int(COLD_BYTES) // (shape[0] * shape[1])))
        copies = [torch.from_numpy(rng.integers(-128, 128, size=shape, dtype=np.int8)).to(dev)
                  for _ in range(n)]
        for B in args.batch:
            xs = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32) / 1000).to(dev)
            amax = xs.abs().amax(dim=1)
            out = {"tree": rwkv_tpu_torch.__file__, "head": name, "batch": B,
                   "warm_ms": graph_median_ms(lambda: fn(xs, copies[0], amax), 50, args.reps),
                   "cold_ms": cold_median_ms(lambda w: fn(xs, w, amax), copies, 12 * n,
                                             args.reps),
                   "copies": n, "card": card}
            print(json.dumps(out), flush=True)
        del copies


if __name__ == "__main__":
    main()
