"""Story generator (counterpart of rwkv_tpu/apps/storygen.py): ingest an
instruction prompt once, snapshot the state, then generate any number of
independent stories from that snapshot.

    python -m rwkv_tpu_torch.apps.storygen --model m.bin --stories 3
    python -m rwkv_tpu_torch.apps.storygen --mock --device cpu
"""

from __future__ import annotations

import argparse
import sys

from rwkv_tpu_torch.apps._common import add_model_args, build_engine

INSTRUCT = (
    "\nBelow is an instruction that describes a task. Write a response that "
    "appropriately completes the request.\n\n# Instruction:\nWrite a short "
    "story about {topic}.\n\n# Response:\n"
)


def main(argv=None):
    p = argparse.ArgumentParser(description="RWKV story generator")
    add_model_args(p)
    p.add_argument("--topic", default="a dragon who learns to paint")
    p.add_argument("--stories", type=int, default=1)
    p.add_argument("--max-tokens", type=int, default=200)
    args = p.parse_args(argv)

    eng = build_engine(args)
    prompt = INSTRUCT.format(topic=args.topic)
    print(f"ingesting prompt ({len(prompt)} chars) ...", file=sys.stderr)
    eng.load_context(prompt)
    snap = eng.snapshot(0)  # a copy of the stream's state + bookkeeping

    for i in range(args.stories):
        eng.restore(snap, 0)
        print(f"\n=== story {i + 1} ===")
        eng.generate(
            "",  # state already holds the prompt
            max_tokens=args.max_tokens,
            temp=args.temp,
            tau=args.tau,
            seed=args.seed + i,
            stop=["\n\n# ", "<|endoftext|>"],
            on_text=lambda s: print(s, end="", flush=True),
        )
        print()


if __name__ == "__main__":
    main()
