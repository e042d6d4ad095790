"""Interactive terminal chat (counterpart of rwkv_tpu/apps/chat.py):
persona-primed dialogue with streaming token output and conversation rewind.

    python -m rwkv_tpu_torch.apps.chat --model m.bin
    python -m rwkv_tpu_torch.apps.chat --mock --device cpu

Commands: /reset (forget everything), /undo (rewind your last exchange),
/quit.
"""

from __future__ import annotations

import argparse
import sys

from rwkv_tpu_torch.apps._common import add_model_args, build_engine

PERSONA = (
    "\nThe following is a verbose and detailed conversation between an AI "
    "assistant called {bot}, and a human user called {user}. {bot} is "
    "intelligent, knowledgeable, wise and polite.\n\n"
    "{user}: What year was the French Revolution?\n\n"
    "{bot}: The French Revolution started in 1789, and lasted 10 years "
    "until 1799.\n\n"
)


def main(argv=None):
    p = argparse.ArgumentParser(description="RWKV terminal chat")
    add_model_args(p)
    p.add_argument("--user", default="Bob")
    p.add_argument("--bot", default="Alice")
    p.add_argument("--max-tokens", type=int, default=256)
    args = p.parse_args(argv)

    eng = build_engine(args)
    persona = PERSONA.format(user=args.user, bot=args.bot)
    print("priming persona ...", file=sys.stderr)
    eng.load_context(persona)
    turn = 0

    snapshots = [eng.snapshot(0)]
    print(f"(chat ready — /reset /undo /quit)\n", file=sys.stderr)
    while True:
        try:
            line = input(f"{args.user}: ")
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if line.strip() == "/quit":
            break
        if line.strip() == "/reset":
            eng.restore(snapshots[0], 0)
            snapshots = snapshots[:1]
            print("(reset)", file=sys.stderr)
            continue
        if line.strip() == "/undo":
            if len(snapshots) > 1:
                snapshots.pop()
            eng.restore(snapshots[-1], 0)
            print("(rewound)", file=sys.stderr)
            continue

        print(f"{args.bot}:", end="", flush=True)
        eng.generate(
            f"{args.user}: {line}\n\n{args.bot}:",
            max_tokens=args.max_tokens,
            temp=args.temp,
            tau=args.tau,
            seed=args.seed + turn,
            stop=[f"\n\n{args.user}:", "\n\n"],
            on_text=lambda s: print(s, end="", flush=True),
        )
        print()
        turn += 1
        snapshots.append(eng.snapshot(0))
        if len(snapshots) > 32:
            snapshots = snapshots[:1] + snapshots[-31:]


if __name__ == "__main__":
    main()
