"""Run one cell of the benchmark once, on the card it is started on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m benchmark.run ...` from the checkout's root). The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with --trace 0, its per-layer ones
with --trace 1), `device`, with --trace 1 `breakdown`, and last `checks`,
every number of the correctness comparison beside its limit; the same
numbers end standard error. Without CUDA, or with fewer cards than the cell
asks for, it prints no result and exits 2.

Set-up (reported as setup_s, from the process's start to the window's
opening): the configuration's family (spec.family) names the kernels, which
are built into the checkout's rwkv_tpu_torch/_build/ on the first run, and
makes the weights on the card from the seed; the engine and pool are built;
admission's shapes are warmed; the traffic starts and runs a few steps,
which capture the pool's CUDA graph. The window then runs for --seconds;
the comparison with the family's reference follows it, after the program's
memory is freed.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))
    # caches of torch's JIT tools stay inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "benchmark" / "_cache" / sub))
    os.environ.setdefault("USE_FLAX", "0")

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rwkv_tpu"})
WARMUP_STEPS = 3  # steps before the window: the first captures the pool's graph


def process_age_s() -> float:
    """Seconds since this process started (/proc), so that set-up counts
    the interpreter's start and the imports."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_IMPORT = process_age_s()
T_IMPORT = time.perf_counter()


def setup_clock() -> float:
    return AGE_AT_IMPORT + time.perf_counter() - T_IMPORT


@dataclasses.dataclass
class Context:
    """What a per-layer reader (layer_metrics/<name>.py) reads."""

    cfg: dict
    window: object
    trace: object
    counters: dict
    setup: dict
    batch: int
    chunk: int


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def card() -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(q.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return out


def step_times(win) -> dict:
    """The window's step() calls: how many admitted, and the mean and
    longest wall time of those that did and of those that did not, in ms."""
    out = {}
    for key, admitted in (("admit", True), ("decode", False)):
        walls = [s.t1 - s.t0 for s in win.steps
                 if s.admitted == admitted and s.t0 >= win.t_start]
        out[f"{key}_steps"] = len(walls)
        out[f"{key}_step_ms"] = 1e3 * sum(walls) / len(walls) if walls else 0.0
        out[f"{key}_step_max_ms"] = 1e3 * max(walls, default=0.0)
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             fault=None, control: bool = False) -> dict:
    """One run of `cell`. device "cpu" (tests only) runs the program's plain
    versions and reports no metric and no device. fault(server), if given,
    breaks the served path before the window (tests). control=True adds the
    control's numbers (control.py)."""
    import torch

    from benchmark import check, e2e, serve, spec
    from benchmark.trace import Tracer, breakdown, reduce
    from benchmark.traffic import Traffic

    cfg, mix, family = cell.config, cell.traffic, cell.family
    on_card = device == "cuda"
    if on_card:
        from rwkv_tpu_torch.ops.cuda import _build

        _build.build(family.KERNELS)
    from rwkv_tpu_torch.utils.metrics import metrics

    ref_tok = family.tokenizer(cfg)
    traffic = Traffic(mix, seed, ref_tok)
    t0 = time.perf_counter()
    weights = family.make(cfg, seed, device)
    server = serve.Server(cfg, family, weights, device)
    if fault is not None:
        fault(server)
    server.sync()
    t1 = time.perf_counter()
    server.warm_prefill()
    marks = {}
    tracer = Tracer() if trace and on_card else None

    def start():
        marks["t_warm_end"] = time.perf_counter()
        marks["setup_s"] = setup_clock()
        marks["c0"] = dict(metrics.snapshot()["counters"])
        if tracer:
            tracer.start()

    def end():
        if tracer:
            tracer.stop()
        marks["c1"] = dict(metrics.snapshot()["counters"])

    win = server.run(traffic, seconds, WARMUP_STEPS, start, end)
    setup = {"load_s": t1 - t0, "warm_s": marks["t_warm_end"] - t1}
    counters = {k: v - marks["c0"].get(k, 0) for k, v in marks["c1"].items()}
    peak = torch.cuda.max_memory_allocated() if on_card else None

    in_flight = server.in_flight()
    states = {rid: server.slot_state(slot) for rid, slot in in_flight.items()}
    lanes = check.pick_lanes(win.recs, in_flight, states, seed)
    server.close()
    del server
    t2 = time.perf_counter()
    numbers = check.judge(lanes, family, weights, cfg, ref_tok, device, control=control)
    phases = dict(setup, setup_s=marks["setup_s"], window_s=win.seconds,
                  check_s=time.perf_counter() - t2, **step_times(win))
    correct, checks = check.verdict(numbers, cell.limits)
    attempted, failed = e2e.attempted_failed(win)
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    if on_card:
        if trace:
            t = reduce(tracer.events, win)
            ctx = Context(cfg=cfg, window=win, trace=t, counters=counters,
                          setup=setup, batch=cfg["engine"]["max_streams"],
                          chunk=cfg["engine"]["step_chunk"])
            metrics_out = {}
            for m in cell.per_layer:
                v = spec.layer_reader(m["name"])(ctx)
                if v is not None:
                    metrics_out[m["name"]] = {"value": v, "unit": m["unit"]}
            out["metrics"] = metrics_out
            out["device"] = dict(card(), memory_peak_bytes=peak, busy_s=t.busy_s,
                                 window_s=t.window_s)
            out["breakdown"] = breakdown(t)
        else:
            values = {"setup_s": marks["setup_s"]}
            values.update({n: f(win) for n, f in e2e.METRICS.items()})
            out["metrics"] = {m["name"]: {"value": values[e2e.quantity(m["name"])],
                                          "unit": m["unit"]} for m in cell.end_to_end}
            out["device"] = dict(card(), memory_peak_bytes=peak)
    out["phases"] = phases
    out["numbers"] = numbers
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import check, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    numbers = out.pop("numbers")
    checks = out.pop("checks")
    out["checks"] = checks
    print("phases " + " ".join(f"{k} {v:.6g}" for k, v in out["phases"].items()), file=sys.stderr)
    print(f"judged {numbers['lanes']} lanes, {numbers['states_judged']} slot states, "
          f"{numbers['tokens_judged']} served tokens", file=sys.stderr)
    for name in check.NUMBERS:
        if name not in checks:
            print(f"reading {name} {numbers[name]!r} (not compared)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
