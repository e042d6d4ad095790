"""The control of the correctness comparison, run on the card at a cell's
own size and load: for each seed, one run of the cell (a window of
--seconds), then the judged lanes compared twice, by the program's outputs
and by the family's reference in its CONTROL precision put in the
program's place (check.py).

    python3 benchmark/control.py --workload <name> --seconds <s> --seeds <n> <n> ...

One JSON line a seed: the program's numbers, the control's, and whether
each comes out correct under checks/<workload>.json. The benchmark's own
runs never run it; tests/test_control.py runs it at a test's size.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

if __name__ == "__main__":
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(Path(here).parent))

import argparse  # noqa: E402
import json  # noqa: E402

from benchmark import check  # noqa: E402


def control_numbers(numbers: dict) -> dict:
    """The control's readings under the names of check.NUMBERS (the
    tokenizer is the program's alone: the control does not replace it)."""
    return {"tokenizer_mismatch": 0, "state_err": numbers["control.state_err"],
            "gap": numbers["control.gap"], "tokens_judged": numbers["tokens_judged"],
            "states_judged": numbers["states_judged"]}


def run(cell, seed: int, seconds: float, device: str = "cuda", fault=None) -> dict:
    from benchmark.run import run_cell

    out = run_cell(cell, seed, seconds, trace=False, device=device, fault=fault, control=True)
    numbers = out["numbers"]
    ctl = control_numbers(numbers)
    return {"seed": seed, "program": {n: numbers[n] for n in check.NUMBERS},
            "program_correct": check.verdict(numbers, cell.limits)[0],
            "control": {n: ctl[n] for n in check.NUMBERS},
            "control_correct": check.verdict(ctl, cell.limits)[0],
            "tokens_judged": numbers["tokens_judged"], "states_judged": numbers["states_judged"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(run(cell, seed, args.seconds)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
