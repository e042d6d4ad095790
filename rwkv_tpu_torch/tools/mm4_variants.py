"""Where kernel K3's time goes: variants of csrc/mm4.cu, each the source with
named text edits, timed against it on one GPU.

    python -m rwkv_tpu_torch.tools.mm4_variants [--variants nocompute nowgmma ...]
                                                [--batch 1 8 16] [--K 1024] [--block B]

Each variant is compiled with _build's nvcc flags into rwkv_tpu_torch/_build/
and called through its C entry at the RWKV-4 430M head shape (K = 1024, O =
50688; --K 4096 --block 256 for 7B widths). Per batch size the variants run
in turns, the unedited source ("base") first and last: the median of 15
replays of one CUDA graph, warm (every call on one weight) and from HBM (the
calls rotate over 6 copies of the weight). The error against mm4_plain is
printed: a variant that skips work gives wrong sums by design.
Prints one JSON line per variant and batch size with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

# name: [(text in csrc/mm4.cu, its replacement)]
EDITS = {
    # the product loop skipped: the weight stream, the staging and the epilogue
    "nocompute": [("for (int ks = 0; ks < kSteps; ++ks) {", "for (int ks = 0; ks < 0; ++ks) {")],
    # the widening kept, each wgmma replaced by one register operation
    "nowgmma": [("for (int m = 0; m < MT; ++m) wgmma_bf16<NT>(acc[m], A[m], desc0 + ((q * N * 32) >> 4));",
                 "for (int m = 0; m < MT; ++m) acc[m][ks & 3] += __uint_as_float(A[m][0] ^ A[m][3]);")],
    # the wgmma kept on unwidened words
    "nowiden": [("for (int m = 0; m < MT; ++m) widen(w[m][ks], A[m]);",
                 "for (int m = 0; m < MT; ++m) A[m][0] = A[m][1] = A[m][2] = A[m][3] = w[m][ks];")],
    # the staging without its loads of xs
    "noload": [("x[it][b][0] = ok ? __ldg(x0 + (size_t)b * a.K) : 0.f;", "x[it][b][0] = ok ? 1.f : 0.f;"),
               ("x[it][b][1] = ok ? __ldg(x0 + (size_t)b * a.K + h) : 0.f;", "x[it][b][1] = 0.f;")],
    # the weight stream never held back for the staging's loads
    "nofirst": [("constexpr bool loads_first = NT >= 3;", "constexpr bool loads_first = false;")],
    # slabs of 1, 2 or 4 boxes instead of the plan's choice
    "mt1": [("for (int m = 4; m >= 1; --m) {", "for (int m = 1; m >= 1; --m) {")],
    "mt2": [("for (int m = 4; m >= 1; --m) {", "for (int m = 2; m >= 2; --m) {")],
    "mt4": [("for (int m = 4; m >= 1; --m) {", "for (int m = 4; m >= 4; --m) {")],
    "rows32": [("constexpr int kRows = 64;", "constexpr int kRows = 32;")],
    "l2none": [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B", "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
}


def build(names) -> dict:
    """{variant: ctypes library}, all compiled at once."""
    from rwkv_tpu_torch.ops.cuda import _build

    src = (_build.CSRC / "mm4.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="mm4_variants-", dir=_build.BUILD_DIR))
    procs = {}
    for name in names:
        text = src
        for old, new in EDITS.get(name, []):
            if old not in text:
                raise SystemExit(f"mm4_variants: {name}: {old!r} is not in csrc/mm4.cu")
            text = text.replace(old, new)
        cu = tmp / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-o", str(tmp / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"mm4_variants: {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        lib.rwkv_mm4.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.rwkv_mm4.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=["nocompute", "nowgmma", "nowiden", "noload"],
                    choices=sorted(EDITS))
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8, 16])
    ap.add_argument("--K", type=int, default=1024)
    ap.add_argument("--block", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    from rwkv_tpu_torch.ops.cuda import mm4 as mm4_mod
    from rwkv_tpu_torch.tools.halves_time import graph_median_ms
    from rwkv_tpu_torch.tools.head_time import cold_median_ms

    if not torch.cuda.is_available():
        raise SystemExit("mm4_variants needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    libs = build(["base", *args.variants])
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    K, O = args.K, 50688
    half = mm4_mod.block_half(args.block, K)
    copies = [torch.from_numpy(rng.integers(-128, 128, size=(K // 2, O), dtype=np.int8)).to(dev)
              for _ in range(6)]
    for B in args.batch:
        xs = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32) / 1000).to(dev)
        out = torch.empty(B, O, device=dev)
        ref = mm4_mod.mm4_plain(xs, copies[0], block=args.block)
        for name in ["base", *args.variants, "base"]:
            lib = libs[name]

            def call(w, lib=lib, name=name):
                err = lib.rwkv_mm4(xs.data_ptr(), w.data_ptr(), out.data_ptr(), None, None, B, K,
                                   O, half, torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"mm4_variants {name}: CUDA error {err}")

            call(copies[0])
            torch.cuda.synchronize()
            print(json.dumps({
                "variant": name, "batch": B, "K": K,
                "max_abs_err": float((out.double() - ref.double()).abs().max()),
                "warm_ms": graph_median_ms(lambda: call(copies[0]), 50, 15),
                "cold_ms": cold_median_ms(call, copies, 48, 15), "card": card}), flush=True)


if __name__ == "__main__":
    main()
