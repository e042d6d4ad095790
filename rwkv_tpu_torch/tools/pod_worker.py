"""One process of a pod whose data axis spans processes
(parallel/multihost.py), checked against a single-process reference.

    python -m rwkv_tpu_torch.tools.pod_worker --params m.bin --write-ref ref.npz
    python -m rwkv_tpu_torch.tools.pod_worker --params m.bin --ref ref.npz \
        --coordinator 127.0.0.1:<port> --processes 2 --process-id <i> \
        [--backend gloo] [--devices cuda:0 [cuda:1 ...]] [--model 1] \
        [--bodies fused halves] [--time-steps 20] [--out logits.npz]
    torchrun --nproc-per-node N -m rwkv_tpu_torch.tools.pod_worker \
        --params m.bin --ref ref.npz --cards K      # K cards a process, model K

--write-ref writes the reference (write_reference) and exits. Then every
process of the job runs the check, with its own --process-id, or under a
launcher with none (its environment names the job, LOCAL_RANK the card). It
does what the JAX package's two-process test worker does, on
torch.distributed:

  1. initialize() with the explicit arguments or the launcher's environment
     (a failed bootstrap raises), pod_mesh(model, devices): the model axis on
     this process's devices (several cards: K7 across them), the data axis
     across the processes;
  2. a psum over 'data' of each process's index + 1 (1 + 2 = 3 for two);
  3. the params, cut over this process's mesh rows: a .bin through
     read_bin(put=make_put(mesh)), or an .npz of the flattened numpy params
     tree (keys joined by "/", as dataclasses.asdict gives it);
  4. for each body, make_tp_step on this process's streams of the reference
     batch (multihost.local_batch), fed the reference's ids: its logits
     against the reference's over the true vocab at a scaled error (max |a -
     b| / max(1, max |b|)) of at most TOL; then 3 steps of typical sampling
     fed per process, one torch.Generator per stream; the sampled ids joined
     over the processes (global_batch); the kernels' launch counts of those
     steps, counted from 0; and, with --time-steps, ms per step over that
     many more steps (on CUDA), first with every process timing at once,
     then each process alone while the others wait at a barrier (one card
     shared by several processes gives a correctness run, not a scaling
     figure);
  5. a process_allgather of each body's checksum (the sum of |logits| over
     the true vocab after the sampled steps).

The reference .npz holds "tokens" [B] (the first step's ids), "logits" [S,
B, Vp] (the single-process step's logits at each of S steps), "ids" [S - 1,
B] (the ids fed at steps 1 .. S - 1) and "vocab" (the true vocab). It prints
one JSON line of what it measured, then "POD_WORKER_OK <process id>". With
--out it writes each body's logits ([S, b, Vp], this process's b streams) to
an .npz.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.convert import params_from_numpy
from rwkv_tpu_torch.models.rwkv4 import init_state
from rwkv_tpu_torch.ops.sampling import typical
from rwkv_tpu_torch.parallel import multihost
from rwkv_tpu_torch.parallel.sharding import make_put, shard_params, tp_vocab_multiple
from rwkv_tpu_torch.parallel.tp_step import make_tp_step
from rwkv_tpu_torch.runtime import graphs as graphs_mod

SAMPLED_STEPS = 3
TOL = 3e-4  # the TP pin: the JAX two-process worker's rtol = atol


def _unflatten(npz) -> dict:
    tree: dict = {}
    for key in npz.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        v = npz[key]
        node[leaf] = int(v) if leaf == "block" else v
    return tree


def load_params(path: str, mesh):
    """The params cut over `mesh`: a .bin (vocab padded for the mesh's tp,
    each tensor cut as it is read) or an .npz of a numpy params tree."""
    from rwkv_tpu_torch.io.binfmt import read_bin

    if path.endswith(".bin"):
        params = read_bin(path, mesh.first_device, put=make_put(mesh),
                          pad_vocab_to=tp_vocab_multiple(mesh.shape["model"]), signed=True)
    else:
        with np.load(path) as z:
            params = params_from_numpy(_unflatten(z), mesh.first_device)
    return shard_params(params, mesh)


def _counts() -> dict:
    return {f"{m.__name__.rsplit('.', 1)[1]}.{n}": getattr(m, n)
            for m, n in graphs_mod.COUNTERS}


def _errs(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, that over max(1, max |b|))."""
    d = (a.double() - b.double()).abs().max().item()
    return d, d / max(1.0, b.double().abs().max().item())


def _ms_per_step(step, sp, tok, state, steps: int):
    """ms per step over `steps` steps fed `tok`; returns (ms, the state)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        _, state = step(sp, tok, state)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps, state


def _barrier():
    if dist.is_initialized():
        dist.barrier()


def run_body(body: str, sp, mesh, ref, state0, time_steps: int):
    """Step `body` over this process's streams against the reference, then
    the sampled loop; returns (its record, its logits [S, b, Vp])."""
    dev = mesh.first_device
    step = make_tp_step(mesh, sp, body=body)
    tokens = multihost.local_batch(torch.as_tensor(ref["tokens"], device=dev), mesh)
    fed = [multihost.local_batch(torch.as_tensor(i, device=dev), mesh) for i in ref["ids"]]
    want = [multihost.local_batch(torch.as_tensor(lg, device=dev), mesh) for lg in ref["logits"]]
    graphs_mod.set_counts([0] * len(graphs_mod.COUNTERS))
    state, got = type(state0)(*(s.clone() for s in state0)), []
    for tok in [tokens] + fed:
        logits, state = step(sp, tok.to(torch.int64), state)
        got.append(logits)
    vocab = int(ref["vocab"])  # the padded ids' -1e9 bias would swamp the scale
    errs = [_errs(g[:, :vocab], w[:, :vocab]) for g, w in zip(got, want)]
    scaled = max(e[1] for e in errs)
    if scaled > TOL:
        raise SystemExit(f"pod_worker: body {body}: scaled error {scaled:.3e} > {TOL} "
                         f"against the reference (per step {errs})")
    pid = multihost.process_index()
    gens = [torch.Generator(device=dev).manual_seed(1000 * pid + i)
            for i in range(tokens.shape[0])]
    logits, trace = got[-1], []
    for _ in range(SAMPLED_STEPS):
        ids = typical(logits, gens, temp=0.9, tau=0.8)
        trace.append(ids)
        logits, state = step(sp, ids, state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = _counts()
    if not torch.isfinite(logits).all():
        raise SystemExit(f"pod_worker: body {body}: non-finite logits after sampling")
    trace = torch.stack(trace)  # [3, b]
    if not ((trace >= 0) & (trace < vocab)).all():
        raise SystemExit(f"pod_worker: body {body}: sampled ids outside the vocab: {trace}")
    joined = multihost.global_batch(trace, dim=1)  # [3, B], every process's streams
    b = trace.shape[1]
    start = mesh.first_row * (b // mesh.local_rows)
    if not torch.equal(joined[:, start:start + b], trace):
        raise SystemExit(f"pod_worker: body {body}: global_batch put this process's ids "
                         f"elsewhere: {joined} against {trace}")
    rec = {"max_abs_err": max(e[0] for e in errs), "max_scaled_err": scaled,
           "launches": launches,
           "sampled": joined.tolist(), "checksum": float(logits[:, :vocab].abs().sum())}
    if time_steps and dev.type == "cuda":
        tok = trace[-1]
        _barrier()  # every process times at once
        rec["ms_per_step"], state = _ms_per_step(step, sp, tok, state, time_steps)
        for p in range(multihost.process_count()):  # then each alone
            _barrier()
            if p == pid:
                rec["ms_per_step_alone"], state = _ms_per_step(step, sp, tok, state,
                                                               time_steps)
        _barrier()
    return rec, torch.stack(got)


def write_reference(path: str, out: str, device, tokens=(3, 150, 7, 299), steps: int = 3):
    """The reference .npz of a .bin: the single-process unsharded step
    (forward_step_fused: K1 + K2 on CUDA, their plain versions on the CPU)
    on len(tokens) streams from init_state, then `steps` steps fed its greedy
    ids. Returns the logits [steps + 1, B, Vp]."""
    from rwkv_tpu_torch.io.binfmt import read_bin, read_header
    from rwkv_tpu_torch.ops.cuda.decode_stack import forward_step_fused

    vocab = read_header(path).vocab_size
    params = read_bin(path, device, pad_vocab_to=512, signed=True)  # the engine's load
    tok = torch.tensor(tokens, device=device)
    logits, st = forward_step_fused(params, tok, init_state(params.config, (len(tokens),),
                                                           device))
    all_logits, ids = [logits], []
    for _ in range(steps):
        ids.append(logits[:, :vocab].argmax(-1))
        logits, st = forward_step_fused(params, ids[-1], st)
        all_logits.append(logits)
    all_logits = torch.stack(all_logits)
    np.savez(out, tokens=tok.cpu().numpy(), logits=all_logits.cpu().numpy(),
             ids=torch.stack(ids).cpu().numpy(), vocab=vocab)
    return all_logits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", required=True, help=".bin or an .npz of a params tree")
    ap.add_argument("--ref", help="the single-process reference .npz")
    ap.add_argument("--write-ref", metavar="OUT",
                    help="write the reference .npz of the --params .bin to OUT and exit")
    ap.add_argument("--coordinator", help="host:port of process 0's store (default: a "
                    "launcher's environment, as torchrun sets it)")
    ap.add_argument("--processes", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: nccl with CUDA)")
    ap.add_argument("--devices", nargs="+", default=None,
                    help="this process's devices (default: --cards cards from "
                    "cuda:cards*$LOCAL_RANK under a launcher, else every visible CUDA device)")
    ap.add_argument("--cards", type=int, default=1,
                    help="cards a process under a launcher (without --devices)")
    ap.add_argument("--model", type=int, default=None, help="TP width (default: the devices)")
    ap.add_argument("--bodies", nargs="+", default=["fused", "halves"])
    ap.add_argument("--time-steps", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=60.0, help="seconds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.write_ref:
        write_reference(args.params, args.write_ref,
                        torch.device(args.devices[0] if args.devices else "cuda"))
        return 0
    if not args.ref:
        ap.error("--ref (or --write-ref) is required")
    devices = args.devices
    if devices is None and "LOCAL_RANK" in os.environ:
        devices = multihost.local_devices(args.cards)

    multihost.initialize(args.coordinator, args.processes, args.process_id,
                         backend=args.backend, timeout=args.timeout)
    try:
        P, pid = multihost.process_count(), multihost.process_index()
        if (args.processes, args.process_id) not in ((None, None), (P, pid)):
            raise SystemExit(f"pod_worker: joined as process {pid} of {P}")
        mesh = multihost.pod_mesh("slice" if args.model is None else args.model, devices)
        dev = mesh.first_device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        n_local = mesh.local_rows * mesh.shape["model"]
        want = {"data": P * n_local // mesh.shape["model"], "model": mesh.shape["model"]}
        if mesh.shape != want:
            raise SystemExit(f"pod_worker: mesh {mesh.shape}, want {want}")

        one = torch.full((mesh.local_rows,), float(pid + 1), device=dev)
        psum = multihost.psum_data(one, mesh)
        if not torch.all(psum == P * (P + 1) / 2):
            raise SystemExit(f"pod_worker: psum over data gave {psum.tolist()}, "
                             f"want {P * (P + 1) / 2}")

        t0 = time.perf_counter()
        sp = load_params(args.params, mesh)
        load_s = time.perf_counter() - t0
        with np.load(args.ref) as z:
            ref = {k: z[k] for k in z.files}
        cfg = RWKVConfig(n_layer=sp.n_layer, n_embd=sp.n_embd, vocab_size=sp.vocab_size)
        B = ref["tokens"].shape[0]
        state0 = multihost.local_batch(init_state(cfg, (B,), device=dev), mesh, dim=1)

        bodies, logits = {}, {}
        for body in args.bodies:
            bodies[body], logits[body] = run_body(body, sp, mesh, ref, state0,
                                                  args.time_steps)
            sums = multihost.process_allgather(torch.tensor(
                [bodies[body]["checksum"]], dtype=torch.float64, device=dev)).reshape(-1)
            if sums.shape != (P,) or not torch.isfinite(sums).all() \
                    or sums[pid].item() != bodies[body]["checksum"]:
                raise SystemExit(f"pod_worker: body {body}: checksum allgather gave "
                                 f"{sums.tolist()}")
            bodies[body]["checksums"] = sums.tolist()
        if args.out:
            np.savez(args.out, **{b: lg.cpu().numpy() for b, lg in logits.items()})
        print(json.dumps({
            "process": pid, "processes": P, "backend": dist.get_backend(),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "mesh": mesh.shape, "local_rows": mesh.local_rows, "first_row": mesh.first_row,
            "psum": psum.tolist(), "load_s": load_s, "bodies": bodies}), flush=True)
        print(f"POD_WORKER_OK {pid}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
