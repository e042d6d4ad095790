"""Shared CLI plumbing for the example apps (counterpart of
rwkv_tpu/apps/_common.py).

The apps run on "cuda" unless given --device cpu, and never fall back to the
CPU on their own. --mock builds a tiny random q8 (or q4) model from a numpy
seed, for demos and tests without a checkpoint.
"""

from __future__ import annotations

import argparse
import os
import sys

from rwkv_tpu_torch.runtime.engine import RWKV

DEFAULT_VOCAB = os.environ.get("RWKV_TPU_VOCAB")


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default=os.environ.get("MODEL_PATH"),
                   help="path to a .bin checkpoint (reference format), a packed q4 "
                        ".safetensors artifact, or a dense .safetensors/.pth RWKV-v4 "
                        "checkpoint (quantized on load)")
    p.add_argument("--quant", choices=("q8", "q4"), default="q8",
                   help="weight format: q8 (reference Q8_0 parity) or q4 (4-bit "
                        "nibble-packed, half the weight bytes a token; needs a dense "
                        ".safetensors/.pth source; with --shards it runs the fused body)")
    p.add_argument("--vocab", default=DEFAULT_VOCAB,
                   help="dir with vocab.json + merges.txt "
                        "(default: the bundled 50,277-entry vocab)")
    p.add_argument("--mock", action="store_true",
                   help="tiny random-weights model (demo/tests, no checkpoint)")
    p.add_argument("--streams", type=int, default=1, help="max parallel streams")
    p.add_argument("--shards", type=int, default=1, metavar="TP",
                   help="tensor-parallel width: shard the model over TP devices "
                        "(parallel/tp_step.py); with one card the mesh names it TP times")
    p.add_argument("--tp-body", choices=("fused", "halves", "plain"), default=None,
                   help="the sharded step's body (default: fused, kernel K7, where it "
                        "is eligible; halves is kernel K6)")
    p.add_argument("--bf16-prefill", action="store_true",
                   help="bf16 operands for prompt ingest's products (float32 sums)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain PyTorch "
                        "path on the host)")
    p.add_argument("--temp", type=float, default=0.9)
    p.add_argument("--tau", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)


def _mesh(shards: int, device):
    """A model-axis mesh of `shards` devices: the visible CUDA devices in
    order, the card repeated when there are fewer (a virtual mesh), or the
    CPU named `shards` times."""
    import torch

    from rwkv_tpu_torch.parallel.mesh import make_mesh

    if device.type == "cuda":
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", i % n) for i in range(shards)]
    else:
        devices = [device] * shards
    return make_mesh(model=shards, devices=devices)


def build_engine(args) -> RWKV:
    import torch

    from rwkv_tpu_torch.runtime.engine import resolve_device

    device = resolve_device(getattr(args, "device", "cuda"))
    pdt = torch.bfloat16 if getattr(args, "bf16_prefill", False) else torch.float32
    sharding = None
    if getattr(args, "shards", 1) > 1:
        sharding = _mesh(args.shards, device)
        print(f"[tp] sharding over {args.shards} devices", file=sys.stderr)
    elif getattr(args, "tp_body", None):
        print("warning: --tp-body has no effect without --shards > 1", file=sys.stderr)
    eng = RWKV(device=None if sharding is not None else device, max_streams=args.streams,
               prefill_dtype=pdt, sharding=sharding, tp_body=getattr(args, "tp_body", None),
               quant=getattr(args, "quant", "q8"))
    if args.mock:
        from rwkv_tpu_torch.models.config import RWKVConfig
        from rwkv_tpu_torch.models.rwkv4 import random_quantized_params_np

        cfg = RWKVConfig(n_layer=2, n_embd=64)
        # tiny E is below every q4 pack block: pair the row-tiled families at E
        eng.load_params(random_quantized_params_np(cfg, seed=0, q4=eng.quant == "q4",
                                                   q4_block=cfg.n_embd))
        print("[mock] tiny random model (output is gibberish by design)", file=sys.stderr)
    elif args.model:
        print(f"loading {args.model} ...", file=sys.stderr)
        eng.load_file(args.model, args.streams)
    else:
        print("error: need --model PATH or --mock", file=sys.stderr)
        sys.exit(2)

    try:
        eng.load_tokenizer(args.vocab)  # None -> bundled 50,277-entry vocab
    except (ValueError, OSError) as e:  # OSError: missing/unreadable files
        print(f"error: no tokenizer vocab ({e}); pass --vocab DIR or set "
              f"$RWKV_TPU_VOCAB", file=sys.stderr)
        sys.exit(2)
    return eng
