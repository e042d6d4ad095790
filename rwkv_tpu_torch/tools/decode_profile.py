"""Where a decode step's time goes on the GPU, at RWKV-4 430M widths.

    python -m rwkv_tpu_torch.tools.decode_profile [--quant q8|q4] [--a8]
                                                  [--tp N [--body fused|halves|plain]
                                                   [--cards]]
                                                  [--batch 1 8 16] [--steps 30] [--seed 0]
    python -m rwkv_tpu_torch.tools.decode_profile --paths [--model 430m|14b] [--layers L]
                                                  [--batch 1 2 4 8 16] [--steps 30]

--paths times kernel K1 alone (decode_stack, q8) on each of its two kernels
at every --batch: the CUDA-core one and the tensor-core one (csrc/stack_tc.cuh),
in turns (cuda, tc, tc, cuda), CUDA events around --steps back-to-back
steps, each path's phases from its %globaltimer stamps, and the plain
version's ms a step; at 14B widths over --layers layers (the weights of 40
would take minutes to make on the host), each time also scaled to 40 layers.
It prints one JSON line per batch size and the B* the times give: the least
B from which the tensor cores win at every measured B.

For each batch size, with random q8 or packed q4 weights from a numpy seed
(q4: the default pairing block, or with --tp the widest that lies inside a
shard, models.rwkv4.q4_pack_block(E, N)), and with --a8 the W8A8 step (q8
weights, kernel K5, the engine's a8 block), or with --tp N the
tensor-parallel step (parallel/tp_step.py) on a mesh that names the card N
times, by default the "fused" body (kernel K7: the whole step of the shards
as one cooperative launch; q8 or q4), or --body halves (q8: kernel K6 per
shard and layer, the head on K2), it measures:
  * wall ms per step of forward_step_fused (CUDA events around `steps`
    back-to-back steps: what a caller that does not read the logits sees);
  * host ms per step: the time the Python + C host code takes to enqueue a
    step (no synchronisation), which bounds the wall time from below when
    the launches, not the kernels, are the limit;
  * device ms per step by kernel (torch.profiler, CUDA activity), and the
    device's busy share of the wall time;
  * without --tp, device ms per step by phase of the decode stack's one
    launch (csrc/decode_stack.cu), from its %globaltimer stamps (block 0's
    clock after each grid barrier), summed over the layers: ln1+mix with
    k/v/r + WKV, output, ln2+mix with key, value+gate, and ln_out; beside
    it the head kernel's time from the profiler (K2 and K5's heads run
    int8_head_kernel, qmv_kernel before their redesign; K3 mm4_kernel,
    qmv_kernel before its: a parent checkout is profiled alike);
  * with --tp and the fused body, device ms per step by phase of K7's one
    launch (csrc/decode_stack_tp.cu), from its stamps likewise, summed over
    the layers: the ffn exchange + ln1+mix with every shard's k/v/r + WKV,
    the output partials, the att exchange + ln2+mix with every shard's key,
    the value partials and gates, and the last exchange + ln_out with the
    shards' head columns;
  * with --tp and --body halves, device ms per step by launch position over
    the eager body (torch.profiler): every device kernel in launch order,
    K6's (csrc/tp_halves.cu, per layer and shard: a1 ln1+mix+k/v/r+WKV, a2
    output partial; f1 ln2+mix+key+gate, f2 value partial), the torch
    kernels between them by the K6 launch they follow (the psum and residual
    add after a2, the psum, gate gather and addcmul after f2), then the mm8
    head of each shard. K6's launches overlap the one before them
    (programmatic dependent launch), so each span is counted from where the
    spans before it ended: the positions sum to the device's busy time;
    also the halves step's wall ms eager (its body called directly) beside
    the engine's graphed step;
  * with --tp, wall ms per step of the unsharded step (forward_step_fused:
    K1 + K2, or K4 + K3 in q4) and of the tensor-parallel step in turns
    (unsharded, tp, tp, unsharded), CUDA events;
  * graph ms per step: the same step captured once in a CUDA graph and
    replayed, which takes the host's launch cost out of the wall time;
  * sampled ms per token: the engine's generate loop without the tokenizer
    (step, typical sampling, then the host reads the ids, every token), by
    the host clock, and the device's busy share of that loop; the sampler's
    device ms per token by kernel (the loop's kernels but the step's);
  * at B=1, engine ms per token: RWKV.generate itself on the same weights
    after a short prompt, by the host clock, its decode replayed from CUDA
    graphs (runtime/graphs.py) and run eagerly, in turns (graphed, eager,
    eager, graphed), each with the device's busy share of generate and the
    host operations that took the most time (torch.profiler); the host ms
    of one decode program's call (k = 1) without waiting for the device.
With --tp N --cards the mesh takes cards 0..N-1, each shard on its own card
(K7 across cards for the fused body, K6 + K2 on each card and the mesh's
collectives between them for halves, torch ops and those collectives for
plain, which only --cards takes), the state resident per card; it then
measures the wall ms per step and per token of the unsharded step on card
0, of the tp step replayed from its CUDA graph across the cards and of the
same body eager, in turns (unsharded, graphed, eager, eager, graphed,
unsharded; host clock, every card synchronized), the launches and
collectives of one replay and the replays made, and for the fused body each
card's phases from its stamps and the share of the launch its waits for the
peers' flags take.
Prints one JSON line per batch size. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from functools import partial


PHASES = ("ln1+mix+k/v/r+wkv", "output", "ln2+mix+key", "value+gate")  # per layer
HEAD_KERNELS = ("qmv_kernel", "mm4_kernel", "int8_head_kernel")  # the head's kernel names in the profiler
HALVES_LAUNCHES = ("a1: ln1+mix+k/v/r+wkv", "a2: output partial", "f1: ln2+mix+key+gate",
                   "f2: value partial")  # K6's launches per layer and shard
FUSED_PHASES = ("ffn exchange+ln1+mix+k/v/r+wkv", "output partial",
                "att exchange+ln2+mix+key", "value partial+gate")  # per layer


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _cards(args) -> None:
    """--tp N --cards: the tp step over cards 0..N-1 beside the unsharded
    step on card 0 (the module docstring)."""
    import numpy as np
    import torch

    from rwkv_tpu_torch.models.config import RWKVConfig
    from rwkv_tpu_torch.models.rwkv4 import (
        init_state,
        params_to,
        q4_pack_block,
        random_quantized_params_np,
        signedize_params,
    )
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
    from rwkv_tpu_torch.ops.cuda.decode_stack import forward_step_fused
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import (
        ShardedState,
        shard_params,
        shard_state,
        tp_vocab_multiple,
    )
    from rwkv_tpu_torch.parallel.tp_step import make_tp_step
    from rwkv_tpu_torch.runtime import graphs as graphs_mod

    n = args.tp
    if torch.cuda.device_count() < n:
        raise SystemExit(f"decode_profile --cards: {n} cards asked, "
                         f"{torch.cuda.device_count()} visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = f"{card[0]}, x{len(card)}"
    cards = [torch.device("cuda", i) for i in range(n)]
    dev = cards[0]
    cfg = RWKVConfig.rwkv4_430m()
    host = signedize_params(params_to(random_quantized_params_np(
        cfg, seed=args.seed, pad_multiple=tp_vocab_multiple(n), q4=args.quant == "q4",
        q4_block=q4_pack_block(cfg.n_embd, n)), "cpu"))
    params = params_to(host, dev)
    mesh = make_mesh(model=n, devices=cards)
    sp = shard_params(host, mesh)
    step = make_tp_step(mesh, sp, body=args.body)
    if not step.graphed:
        raise SystemExit("decode_profile --cards: the step over the cards is not graphed")
    rng = np.random.default_rng(args.seed)
    L = cfg.n_layer

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    for B in args.batch:
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        st1, stn = init_state(cfg, (B,), device=dev), ShardedState.zeros(cfg, B, mesh)
        runs = {"tp=1": lambda: forward_step_fused(params, tok, st1),  # noqa: B023
                f"tp={n} graphed": lambda: step(sp, tok, stn),  # noqa: B023
                f"tp={n} eager": lambda: step.eager(sp, tok, stn)}  # noqa: B023
        turns = {}
        for name in ("tp=1", f"tp={n} graphed", f"tp={n} eager", f"tp={n} eager",
                     f"tp={n} graphed", "tp=1"):
            for _ in range(3):
                runs[name]()
            sync()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                runs[name]()
            sync()
            turns.setdefault(name, []).append((time.perf_counter() - t0) * 1e3 / args.steps)
        graphs_mod.set_counts([0] * len(graphs_mod.counts(mesh)), mesh)
        step(sp, tok, stn)
        sync()
        names = [f"{m.__name__.rsplit('.', 1)[1]}.{a}" for m, a in graphs_mod.COUNTERS]
        per_step = {k: v for k, v in zip(names + list(mesh.collectives),
                                         graphs_mod.counts(mesh)) if v}
        phases, waits = {}, []
        if args.body == "fused" and B <= k7.FUSE_EMBED_MAX_B:
            local = [sp.local(0, j) for j in range(n)]
            s = shard_state(init_state(cfg, (B,), device=dev), mesh)[0]
            stamps = [torch.zeros((args.steps, 6 * L + 3), dtype=torch.int64, device=d)
                      for d in cards]
            for i in range(args.steps):
                s = k7.decode_stack_tp(sp.rows[0], s, local, token=tok,
                                       stamps=[t[i] for t in stamps])[1]
            sync()
            for c, t in enumerate(stamps):
                t = t.double().cpu()
                ms = (t[:, 1:4 * L + 2] - t[:, :4 * L + 1]).mean(0) / 1e6
                total = float((t[:, 4 * L + 1] - t[:, 0]).mean() / 1e6)
                wait = (t[:, 4 * L + 2] - t[:, 0]).mean() / 1e6
                for l in range(L):
                    wait += (t[:, 4 * L + 3 + 2 * l] - t[:, 2 + 4 * l]).mean() / 1e6
                    wait += (t[:, 4 * L + 4 + 2 * l] - t[:, 4 + 4 * l]).mean() / 1e6
                waits.append(float(wait) / total)
                if c == 0:
                    for k in range(4 * L):
                        phases[FUSED_PHASES[k % 4]] = phases.get(FUSED_PHASES[k % 4], 0.0) \
                            + float(ms[k])
                    phases["last exchange+ln_out+head"] = float(ms[4 * L])
                    phases["launch (first stamp to last)"] = total
        print(json.dumps({
            "quant": args.quant, "tp": n, "cards": n, "body": args.body, "batch": B,
            "wall_ms_per_step_in_turns": turns,
            "wall_ms_per_token": {k: min(v) / B for k, v in turns.items()},
            "per_step": per_step, "replays": step.graphs.replays,
            **({"card0_device_ms_per_step_by_phase": phases,
                "exchange_wait_share_by_card": waits} if phases else {}),
            "card": card}))


def _paths(args) -> None:
    """--paths: K1 on the CUDA cores and on the tensor cores, in turns."""
    import numpy as np
    import torch

    from rwkv_tpu_torch.models.config import RWKVConfig
    from rwkv_tpu_torch.models.rwkv4 import (
        init_state,
        params_to,
        random_quantized_params_np,
        signedize_params,
    )
    from rwkv_tpu_torch.ops.cuda import decode_stack as ds_mod

    if not torch.cuda.is_available():
        raise SystemExit("decode_profile needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    full = 24 if args.model == "430m" else 40
    L = args.layers or full
    E = 1024 if args.model == "430m" else 5120
    cfg = RWKVConfig(n_layer=L, n_embd=E, vocab_size=1000)
    params = params_to(signedize_params(random_quantized_params_np(cfg, seed=args.seed)), dev)
    rng = np.random.default_rng(args.seed)
    tc_wins = {}
    for B in args.batch:
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        st = init_state(cfg, (B,), device=dev)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        def timed(tc, steps):
            s = ds_mod.decode_stack(params, tok, st, tc=tc)[1]
            torch.cuda.synchronize()
            a.record()
            for _ in range(steps):
                s = ds_mod.decode_stack(params, tok, s, tc=tc)[1]
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / steps

        turns = {"cuda": [], "tc": []}
        for name in ("cuda", "tc", "tc", "cuda"):
            turns[name].append(timed(name == "tc", args.steps))
        phases = {}
        for name in ("cuda", "tc"):
            stamps = torch.zeros((args.steps, 4 * L + 2), dtype=torch.int64, device=dev)
            s = st
            for i in range(args.steps):
                s = ds_mod.decode_stack(params, tok, s, tc=name == "tc", stamps=stamps[i])[1]
            torch.cuda.synchronize()
            ms = (stamps[:, 1:] - stamps[:, :-1]).double().mean(0).cpu() / 1e6
            by = defaultdict(float)
            for k in range(4 * L):
                by[PHASES[k % 4]] += float(ms[k])
            by["ln_out"] = float(ms[4 * L])
            phases[name] = dict(by)
        ds_mod.decode_stack_plain(params, tok, st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds_mod.decode_stack_plain(params, tok, st)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        best = {k: min(v) for k, v in turns.items()}
        tc_wins[B] = best["tc"] < best["cuda"]
        scale = full / L
        print(json.dumps({"model": args.model, "layers": L, "B": B, "ms": turns,
                          "ms_scaled_to_full": {k: v * scale for k, v in best.items()},
                          "plain_ms": plain_ms, "plain_ms_scaled_to_full": plain_ms * scale,
                          "phases_ms": phases, "card": card}), flush=True)
    b_star = next((B for B in sorted(tc_wins) if all(tc_wins[x] for x in tc_wins if x >= B)),
                  None)
    print(json.dumps({"model": args.model, "b_star": b_star, "tc_wins": tc_wins}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quant", choices=["q8", "q4"], default="q8")
    ap.add_argument("--a8", action="store_true", help="the W8A8 step (q8 weights only)")
    ap.add_argument("--tp", type=int, default=0,
                    help="the tensor-parallel step on a mesh naming the card N times")
    ap.add_argument("--body", choices=["fused", "halves", "plain"], default="fused",
                    help="the tensor-parallel step's body (with --tp; plain with --cards)")
    ap.add_argument("--cards", action="store_true",
                    help="with --tp N: the mesh over cards 0..N-1, one shard a card")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", action="store_true",
                    help="K1 alone on the CUDA cores and on the tensor cores, in turns")
    ap.add_argument("--model", choices=["430m", "14b"], default="430m",
                    help="with --paths: the widths")
    ap.add_argument("--layers", type=int, default=0,
                    help="with --paths: layers (0: the model's own)")
    args = ap.parse_args()
    if args.paths:
        _paths(args)
        return
    if args.a8 and args.quant == "q4":
        ap.error("--a8 runs on q8 weights")
    if args.tp and args.a8:
        ap.error("--tp runs without --a8")
    if args.tp and args.quant == "q4" and args.body != "fused":
        ap.error("4-bit weights run the tensor-parallel step through --body fused only")
    if args.body == "plain" and not args.cards:
        ap.error("--body plain is profiled over cards only (--tp N --cards)")
    if args.cards:
        if args.tp < 2:
            ap.error("--cards needs --tp 2 or more")
        _cards(args)
        return

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rwkv_tpu_torch.models.config import RWKVConfig
    from rwkv_tpu_torch.models.rwkv4 import (
        a8_block_for,
        init_state,
        params_to,
        q4_pack_block,
        random_quantized_params_np,
        signedize_params,
    )
    from rwkv_tpu_torch.ops.cuda import decode_stack as ds_mod
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
    from rwkv_tpu_torch.ops.cuda.decode_stack import forward_step_fused
    from rwkv_tpu_torch.ops.layernorm import layer_norm
    from rwkv_tpu_torch.ops.sampling import typical
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import shard_params, shard_state
    from rwkv_tpu_torch.parallel.tp_step import make_engine_step, make_tp_step
    from rwkv_tpu_torch.runtime.engine import RWKV

    if not torch.cuda.is_available():
        raise SystemExit("decode_profile needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = RWKVConfig.rwkv4_430m()
    host = random_quantized_params_np(cfg, seed=args.seed, q4=args.quant == "q4",
                                      q4_block=q4_pack_block(cfg.n_embd, max(args.tp, 1)))
    params = params_to(signedize_params(host), dev)
    head = "head (mm4)" if args.quant == "q4" else ("head (mm8_a8)" if args.a8 else "head (mm8)")
    k1_step = forward_step_fused
    mesh = None
    if args.a8:
        forward_step_fused = partial(forward_step_fused, a8=True,
                                     a8_block=a8_block_for(cfg.n_embd))
    if args.tp:
        mesh = make_mesh(model=args.tp, devices=[dev] * args.tp)
        sharded = shard_params(params, mesh)
        tp_step = make_engine_step(mesh, sharded, body=args.body)
        raw = make_tp_step(mesh, sharded, body=args.body)
        eager_body = getattr(raw, "eager", raw)

        def forward_step_fused(_, token, state):  # noqa: F811: the step profiled
            return tp_step(sharded, token, state)

        def eager_step(_, token, state):  # the body without its CUDA graph
            return eager_body(sharded, token, state)

        head = "head (mm8)" if args.body == "halves" else "head"
    rng = np.random.default_rng(args.seed)

    for B in args.batch:
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        st = init_state(cfg, (B,), device=dev)

        def run(n):
            s = st
            for _ in range(n):
                _, s = forward_step_fused(params, tok, s)
            return s

        run(3)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        run(args.steps)
        host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        b.record()
        b.synchronize()
        wall_ms = a.elapsed_time(b) / args.steps

        turns = {}
        if args.tp:  # the unsharded step and the tp step, in turns
            def timed(fn):
                fn(params, tok, st)
                torch.cuda.synchronize()
                a.record()
                s = st
                for _ in range(args.steps):
                    _, s = fn(params, tok, s)
                b.record()
                b.synchronize()
                return a.elapsed_time(b) / args.steps

            ref = "k4" if args.quant == "q4" else "k1"  # the unsharded step
            for name in (ref, "tp", "tp", ref):
                turns.setdefault(name, []).append(
                    timed(k1_step if name == ref else forward_step_fused))

        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run(args.steps)
        graph.replay()
        torch.cuda.synchronize()
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        graph_ms = a.elapsed_time(b) / args.steps
        del graph

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(args.steps)
            torch.cuda.synchronize()
        by_kernel = defaultdict(float)
        for evt in prof.key_averages():
            us = _device_us(evt)
            if us > 0 and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
                by_kernel[evt.key] += us / 1e3 / args.steps
        device_ms = sum(by_kernel.values())
        ours = sorted((e for e in prof.events()
                       if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                       and "rwkv::" in e.name), key=lambda e: e.time_range.start)
        n = args.tp
        fused = n and args.body == "fused"
        by_position = defaultdict(float)
        eager_wall = None
        if n and not fused:  # per layer: n att halves (a1, a2), then n ffn halves (f1, f2)
            s = st
            for _ in range(3):
                _, s = eager_step(params, tok, s)
            torch.cuda.synchronize()
            a.record()
            for _ in range(args.steps):
                _, s = eager_step(params, tok, s)
            b.record()
            b.synchronize()
            eager_wall = a.elapsed_time(b) / args.steps
            with profile(activities=[ProfilerActivity.CUDA]) as prof_h:
                for _ in range(args.steps):
                    _, s = eager_step(params, tok, s)
                torch.cuda.synchronize()
            kernels = sorted((e for e in prof_h.events()
                              if getattr(e, "device_type", None)
                              == torch.autograd.DeviceType.CUDA),
                             key=lambda e: e.time_range.start)
            per_step = 4 * cfg.n_layer * n + n
            i, label, end = 0, None, None
            for e in kernels:
                if "rwkv::" in e.name:
                    j = i % per_step
                    k = j % (4 * n)
                    label = (head if j >= 4 * cfg.n_layer * n
                             else HALVES_LAUNCHES[k % 2] if k < 2 * n
                             else HALVES_LAUNCHES[2 + (k - 2 * n) % 2])
                    i += 1
                    key = label
                else:
                    key = f"torch after {label}" if label else "torch before a1"
                t0_, t1_ = e.time_range.start, e.time_range.end
                if end is not None:
                    t0_ = max(t0_, end)
                end = t1_ if end is None else max(end, t1_)
                by_position[key] += max(0, t1_ - t0_) / 1e3 / args.steps
        else:  # one launch a step: its phases from the kernel's own stamps
            L = cfg.n_layer
            stamps = torch.zeros((args.steps, 4 * L + 2), dtype=torch.int64, device=dev)
            if fused:
                local = [sharded.local(0, j) for j in range(n)]
                kw = ({"token": tok} if B <= k7.FUSE_EMBED_MAX_B else
                      {"x": layer_norm(params.emb[tok], params.ln0.weight, params.ln0.bias)})
                s = shard_state(st, mesh)[0]
                for i in range(args.steps):
                    s = k7.decode_stack_tp(sharded.rows[0], s, local, stamps=stamps[i], **kw)[1]
            else:
                s = st
                for i in range(args.steps):
                    s = ds_mod.decode_stack(params, tok, s, a8=args.a8,
                                            a8_block=a8_block_for(cfg.n_embd) if args.a8
                                            else None, stamps=stamps[i])[1]
            torch.cuda.synchronize()
            ms = (stamps[:, 1:] - stamps[:, :-1]).double().mean(0).cpu() / 1e6
            for k in range(4 * L):
                by_position[(FUSED_PHASES if fused else PHASES)[k % 4]] += float(ms[k])
            if fused:
                by_position["last exchange+ln_out+head"] = float(ms[4 * L])
            else:
                by_position["ln_out"] = float(ms[4 * L])
            by_position["stack (first stamp to last)"] = float(ms.sum())
            if not fused:
                by_position[head] = sum(v for k, v in by_kernel.items()
                                        if any(n in k for n in HEAD_KERNELS))
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)

        def sampled(n):
            t, s = tok, st
            for _ in range(n):
                logits, s = forward_step_fused(params, t, s)
                t = typical(logits, gen)
                t.tolist()  # the host read generate() makes per token

        sampled(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampled(args.steps)
        sampled_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_s:
            t0 = time.perf_counter()
            sampled(args.steps)
            traced_ms = (time.perf_counter() - t0) * 1e3
        sampled_busy = sum(_device_us(e) for e in prof_s.key_averages()
                           if getattr(e, "device_type", None)
                           == torch.autograd.DeviceType.CUDA) / 1e3 / traced_ms
        # the sampler's device time by kernel: every device kernel of the loop
        # but the step's own (ours, K2/K3/K5's heads and the TP body's)
        step_kernels = set(by_kernel)
        sampler = sorted(((e.key, _device_us(e) / 1e3 / args.steps)
                          for e in prof_s.key_averages()
                          if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                          and e.key not in step_kernels), key=lambda kv: -kv[1])

        engine = {}
        if B == 1:
            eng = RWKV(device=dev, sharding=mesh, tp_body=args.body if mesh else None)
            eng.load_params(host, a8=args.a8)
            eng.load_tokenizer()

            def request(profiled=False):
                """ms of one generate of args.steps tokens after a prompt, or
                the device's busy share of it and the host ops by time."""
                eng.reset_state()
                eng.load_context("In a hole in the ground there lived a hobbit.")
                torch.cuda.synchronize()
                if profiled:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof_e:
                        t0 = time.perf_counter()
                        eng.generate("", max_tokens=args.steps, seed=args.seed)
                        torch.cuda.synchronize()
                        traced_ms = (time.perf_counter() - t0) * 1e3
                    evts = prof_e.key_averages()
                    busy = sum(_device_us(e) for e in evts if getattr(e, "device_type", None)
                               == torch.autograd.DeviceType.CUDA) / 1e3
                    top = sorted(((e.key, e.self_cpu_time_total / 1e3 / args.steps)
                                  for e in evts if getattr(e, "device_type", None)
                                  == torch.autograd.DeviceType.CPU), key=lambda kv: -kv[1])
                    return busy / traced_ms, dict(top[:8])
                t0 = time.perf_counter()
                eng.generate("", max_tokens=args.steps, seed=args.seed)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

            request()  # the warm-up: each program captured
            eng_turns = {"graphed": [], "eager": []}
            for mode in ("graphed", "eager", "eager", "graphed"):  # in turns
                eng._graphs.enabled = mode == "graphed"
                eng_turns[mode].append(request() / args.steps)
            traced = {}
            for mode in ("graphed", "eager"):
                eng._graphs.enabled = mode == "graphed"
                traced[mode] = request(profiled=True)
            eng._graphs.enabled = True
            # the host's cost of one decode program (k = 1) from the engine's
            # call, without waiting for the device: what paces chunk 1 when
            # the device waits for the host's read of the last id
            carry = (torch.tensor(187, device=dev), eng.get_state(0),
                     torch.tensor(0.9, dtype=torch.float64, device=dev),
                     torch.tensor(0.8, device=dev),
                     torch.zeros(eng.config.vocab_size, dtype=torch.bool, device=dev))
            prog = partial(eng._decode_k, k=1)
            for _ in range(2):
                _, *carry = eng._graphs(((), 1), prog, *carry)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                _, *carry = eng._graphs(((), 1), prog, *carry)
            host_replay_ms = (time.perf_counter() - t0) * 1e3 / args.steps
            torch.cuda.synchronize()
            engine = {"engine_ms_per_token": min(eng_turns["graphed"]),
                      "engine_eager_ms_per_token": min(eng_turns["eager"]),
                      "engine_ms_per_token_in_turns": eng_turns,
                      "engine_graphs": len(eng._graphs),
                      "engine_host_ms_per_replay": host_replay_ms,
                      "engine_device_busy_share": traced["graphed"][0],
                      "engine_eager_device_busy_share": traced["eager"][0],
                      "engine_host_ms_per_token_by_op": traced["graphed"][1],
                      "engine_eager_host_ms_per_token_by_op": traced["eager"][1]}
            del eng

        out = {"quant": args.quant, "a8": args.a8, "tp": args.tp,
               **({"body": args.body} if args.tp else {}), "batch": B,
               "wall_ms_per_step": wall_ms, "host_enqueue_ms_per_step": host_ms,
               **({"wall_ms_per_step_in_turns": turns} if turns else {}),
               **({"eager_wall_ms_per_step": eager_wall} if eager_wall is not None else {}),
               "graph_ms_per_step": graph_ms,
               "sampled_ms_per_token": sampled_ms,
               "sampled_device_busy_share": sampled_busy,
               "sampler_device_ms_per_token": sum(v for _, v in sampler),
               "sampler_device_ms_per_token_by_kernel": dict(sampler[:12]),
               "device_ms_per_step": device_ms,
               "device_busy_share": device_ms / wall_ms if wall_ms else None,
               "device_ms_per_step_by_kernel": dict(sorted(by_kernel.items(),
                                                           key=lambda kv: -kv[1])),
               ("device_ms_per_step_by_launch" if n and not fused
                else "device_ms_per_step_by_phase"): dict(by_position),
               "rwkv_kernels_seen": len(ours),
               **engine,
               "card": card}
        print(json.dumps(out))


if __name__ == "__main__":
    main()
