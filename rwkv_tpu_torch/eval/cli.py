"""Perplexity / quantization-gate CLI over eval/ppl.py (counterpart of
rwkv_tpu/eval/cli.py).

  python -m rwkv_tpu_torch.eval.cli --model model.bin --text wiki.txt
  python -m rwkv_tpu_torch.eval.cli --model model.safetensors --text wiki.txt --gate 0.05
  python -m rwkv_tpu_torch.eval.cli --model model.bin --text wiki.txt --device cpu

With --gate, a dense (unquantized) load of the same checkpoint is evaluated
too (a .pth/.safetensors input: a .bin stores only the quantized weights),
and the process exits 1 when ppl(quant) - ppl(dense) exceeds the gate.
Runs on "cuda" unless given --device cpu.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Perplexity eval / quantization quality gate")
    p.add_argument("--model", required=True, help=".bin, .pth or .safetensors checkpoint")
    p.add_argument("--text", required=True,
                   help="UTF-8 text file to evaluate (teacher-forced)")
    p.add_argument("--vocab", default=None,
                   help="tokenizer vocab dir (default: bundled 20B vocab)")
    p.add_argument("--chunk", type=int, default=256,
                   help="prefill chunk length (fixed-memory streaming)")
    p.add_argument("--max-tokens", type=int, default=0,
                   help="evaluate at most N tokens (0 = all)")
    p.add_argument("--bf16", action="store_true",
                   help="evaluate the bf16 prefill numerics")
    p.add_argument("--gate", type=float, default=None, metavar="DELTA",
                   help="also eval the dense weights; fail (exit 1) if "
                        "ppl(quant)-ppl(dense) > DELTA")
    p.add_argument("--quant", choices=("q8", "q4"), default="q8",
                   help="quantization under test (q4 = the 4-bit serving "
                        "format; needs a dense .pth/.safetensors input)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain path on the host)")
    args = p.parse_args(argv)
    if args.gate is not None and args.model.endswith(".bin"):
        # argv-decidable: reject before the (potentially multi-GB) load
        p.error("--gate needs the dense weights: use the .pth/"
                ".safetensors checkpoint, not the quantized .bin")
    if args.quant == "q4" and args.model.endswith(".bin"):
        p.error("--quant q4 needs a dense .pth/.safetensors input "
                "(.bin stores Q8 already)")

    import torch

    from rwkv_tpu_torch.eval.ppl import evaluate_nll
    from rwkv_tpu_torch.models.rwkv4 import params_to
    from rwkv_tpu_torch.runtime.engine import resolve_device
    from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer

    dev = resolve_device(args.device)
    tok = BPETokenizer.load(args.vocab)
    with open(args.text, "r", encoding="utf-8") as f:
        ids = tok.encode(f.read())
    if args.max_tokens:
        ids = ids[: args.max_tokens]
    if len(ids) < 2:
        p.error(f"{args.text}: needs at least 2 tokens after encoding")

    if args.model.endswith(".bin"):
        from rwkv_tpu_torch.io.binfmt import read_bin

        qparams = read_bin(args.model, dev)
    else:
        from rwkv_tpu_torch.io.convert import load_checkpoint_quantized

        qparams = params_to(load_checkpoint_quantized(
            args.model, bits=4 if args.quant == "q4" else 8), dev)

    cdt = torch.bfloat16 if args.bf16 else torch.float32
    q = evaluate_nll(qparams, ids, chunk=args.chunk, compute_dtype=cdt)
    out = {"model": args.model, "quant": args.quant, "tokens": q["tokens"],
           "quant_ppl": q["ppl"], "quant_nll": q["nll"],
           "bits_per_token": q["bits_per_token"]}

    ok = True
    if args.gate is not None:
        from rwkv_tpu_torch.io.convert import load_checkpoint

        del qparams
        dense = params_to(load_checkpoint(args.model), dev)
        d = evaluate_nll(dense, ids, chunk=args.chunk, compute_dtype=cdt)
        out["dense_ppl"] = d["ppl"]
        out["ppl_delta"] = q["ppl"] - d["ppl"]
        out["gate"] = args.gate
        ok = out["ppl_delta"] <= args.gate
        out["gate_passed"] = bool(ok)

    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
