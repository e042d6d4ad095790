"""One process of a pod (parallel/multihost.py), checked against a
single-process reference.

    python -m rwkv_tpu_torch.tools.pod_worker --params m.bin --write-ref ref.npz
    python -m rwkv_tpu_torch.tools.pod_worker --params m.bin --ref ref.npz \
        --coordinator 127.0.0.1:<port> --processes 2 --process-id <i> \
        [--backend gloo] [--devices cuda:0 [cuda:1 ...]] [--model 1] \
        [--bodies fused halves plain] [--time-steps 20] [--out logits.npz]
    torchrun --nproc-per-node N -m rwkv_tpu_torch.tools.pod_worker \
        --params m.bin --ref ref.npz --cards K      # K cards a process, model K
    torchrun --nproc-per-node 4 -m rwkv_tpu_torch.tools.pod_worker \
        --params m.bin --ref ref.npz --model 4      # one card a process, a row of 4

--write-ref writes the reference (write_reference) and exits. Then every
process of the job runs the check, with its own --process-id, or under a
launcher with none (its environment names the job, LOCAL_RANK the card). It
does what the JAX package's two-process test worker does, on
torch.distributed:

  1. initialize() with the explicit arguments or the launcher's environment
     (a failed bootstrap raises), pod_mesh(model, devices): a model width
     that divides this process's devices keeps each row inside the process
     (several cards: K7 across them); a multiple of them makes each row
     span model / devices consecutive processes (one card a process: K7
     across processes, the other bodies' collectives over the row's group);
     the data axis takes the rest;
  2. a psum over 'data' of each row's first process's index + 1;
  3. the params, cut over this process's rows and shards: a .bin through
     read_bin(put=make_put(mesh)), an .npz of the flattened numpy params
     tree (keys joined by "/", as dataclasses.asdict gives it), or
     "random:<L>x<E>:<seed>", random_quantized_params_np's weights padded
     for the mesh's tp (each process makes them, then keeps its shards);
  4. for each body and reference, make_tp_step on this process's streams of
     the reference batch (multihost.local_batch) with the state resident
     per shard, fed the reference's ids: its logits against the
     reference's over the true vocab at a scaled error (max |a - b| /
     max(1, max |b|)) of at most TOL, with the mesh's collectives counted;
     then 3 steps of typical sampling, one torch.Generator per stream (the
     ids broadcast over the row's group from its shard-0 process); the
     sampled ids joined over the data rows (global_batch); the kernels'
     launch counts of those steps, counted from 0; and, with --time-steps,
     ms per step over that many more steps (on CUDA): with every process
     timing at once, and, for a graphed step, its eager body and the graph
     in turns; where rows lie inside processes, each process alone too
     (one card shared by several processes gives a correctness run, not a
     scaling figure);
  5. a process_allgather of each body's checksum (the sum of |logits| over
     the true vocab after the sampled steps).

--expect-refused BODY: make_tp_step(body), or its first step on the first
reference's tokens, must raise (kernel K7 on a row whose processes share a
card); its message is recorded. --k7-check: kernel
K7 across processes against its plain version on the same inputs (2 steps
a reference), logits and states at K7_TOL, then, on CUDA, the ms a step
of each over K7_TIMED more steps. --engine-ref REF: the engine and
the pool on the --params .bin over the mesh (engine_check), against
write_engine_reference's trajectories; the engine and the pool are still
held when the process leaves. Before it exits a process frees its CUDA
graphs, releases K7's regions across processes and leaves the group
(multihost.shutdown).

A reference .npz holds "tokens" [B] (the first step's ids), "logits" [S,
B, Vp] (the single-process step's logits at each of S steps), "ids" [S - 1,
B] (the ids fed at steps 1 .. S - 1) and "vocab" (the true vocab). It prints
one JSON line of what it measured, then "POD_WORKER_OK <process id>". With
--out it writes each body's logits ([S, b, Vp], this process's b streams, of
the first reference) to an .npz.
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
from rwkv_tpu_torch.models.rwkv4 import (
    WKVState,
    init_state,
    params_to,
    q4_pack_block,
    random_quantized_params_np,
    signedize_params,
)
from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
from rwkv_tpu_torch.ops.quant import Quant4Linear
from rwkv_tpu_torch.ops.sampling import typical
from rwkv_tpu_torch.parallel import multihost
from rwkv_tpu_torch.parallel.sharding import (
    ShardedState,
    make_put,
    shard_params,
    tp_vocab_multiple,
)
from rwkv_tpu_torch.parallel.tp_step import make_tp_step
from rwkv_tpu_torch.runtime import graphs as graphs_mod

SAMPLED_STEPS = 3
TOL = 3e-4  # the TP pin: the JAX two-process worker's rtol = atol
K7_TOL = 1e-4  # K7 against its plain version
K7_TIMED = 5  # --k7-check's timed steps of K7 and of its plain version
PROMPTS = ("The quick brown fox", "Once upon a time, in a land far away,",
           "def fibonacci(n):\n")
ENGINE_STEPS = 16
GENERATE_TOKENS = 24  # engine_check's generate calls, at tau = 0


def pool_requests() -> list:
    """engine_check's pool requests, at tau = 0: (prompt, max_tokens, temp,
    seed)."""
    return [(PROMPTS[i % 3] + " " * (i // 3), 12 + i, 0.7 + 0.05 * i, i) for i in range(12)]


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


def random_params(spec: str, pad_multiple: int, tp: int = 1):
    """"random:<L>x<E>:<seed>": random_quantized_params_np's q8 weights at
    n_layer L and n_embd E (V = 50277, F = 4E), vocab padded to
    pad_multiple, signedized, on the host; "random:<L>x<E>:<seed>:q4": its
    4-bit weights, the row-tiled families paired in blocks inside a shard of
    tp (q4_pack_block(E, tp))."""
    shape, seed, *quant = spec.split(":")[1:]
    L, E = (int(v) for v in shape.split("x"))
    if quant not in ([], ["q4"]):
        raise ValueError(f"pod_worker: {spec!r}: want random:<L>x<E>:<seed>[:q4]")
    q4 = quant == ["q4"]
    return signedize_params(params_to(random_quantized_params_np(
        RWKVConfig(n_layer=L, n_embd=E), seed=int(seed), pad_multiple=pad_multiple, q4=q4,
        q4_block=q4_pack_block(E, tp) if q4 else None), "cpu"))


def load_params(path: str, mesh):
    """The params cut over `mesh`: a .bin (vocab padded for the mesh's tp,
    each tensor cut as it is read), an .npz of a numpy params tree, or
    "random:<L>x<E>:<seed>"; a process keeps only its own shards."""
    from rwkv_tpu_torch.io.binfmt import read_bin

    multiple = tp_vocab_multiple(mesh.shape["model"])
    if path.startswith("random:"):
        return shard_params(random_params(path, multiple, mesh.shape["model"]), mesh)
    if path.endswith(".bin"):
        params = read_bin(path, mesh.first_device, put=make_put(mesh), pad_vocab_to=multiple,
                          signed=True)
    else:
        with np.load(path) as z:
            params = params_from_numpy(_unflatten(z), "cpu")
    return shard_params(params, mesh)


def _counts() -> dict:
    return {f"{m.__name__.rsplit('.', 1)[1]}.{n}": getattr(m, n)
            for m, n in graphs_mod.COUNTERS}


def _errs(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, that over max(1, max |b|))."""
    d = (a.double() - b.double()).abs().max().item()
    return d, d / max(1.0, b.double().abs().max().item())


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms_per_step(step, sp, tok, state, steps: int):
    """ms per step over `steps` steps fed `tok`; returns (ms, the state)."""
    dev = tok.device
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        _, state = step(sp, tok, state)
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / steps, state


def _barrier():
    if dist.is_initialized():
        dist.barrier()


def _shard_record(sp) -> dict:
    """What this process holds of the params: its bytes and a few shapes."""
    n = 0
    seen = set()
    for row in sp.rows:
        for p in row:
            stack = [p]
            while stack:
                node = stack.pop()
                if torch.is_tensor(node):
                    if id(node) not in seen:
                        seen.add(id(node))
                        n += node.numel() * node.element_size()
                elif hasattr(node, "__dataclass_fields__"):
                    stack.extend(getattr(node, f) for f in node.__dataclass_fields__)
    p = sp.rows[0][0]
    codes = [lin.wp if isinstance(lin, Quant4Linear) else lin.w for lin in (p.att.key, p.head)]
    return {"shard_bytes": n, "emb_shape": list(p.emb.shape),
            "att_key_shape": list(codes[0].shape), "head_shape": list(codes[1].shape)}


def run_body(body: str, sp, mesh, ref, time_steps: int):
    """Step `body` over this process's streams against the reference, then
    the sampled loop; returns (its record, its logits [S, b, Vp])."""
    dev = mesh.first_device
    step = make_tp_step(mesh, sp, body=body)
    tokens = multihost.local_batch(torch.as_tensor(ref["tokens"], device=dev), mesh)
    fed = [multihost.local_batch(torch.as_tensor(i, device=dev), mesh) for i in ref["ids"]]
    want = [multihost.local_batch(torch.as_tensor(lg, device=dev), mesh) for lg in ref["logits"]]
    B = ref["tokens"].shape[0]
    cfg = RWKVConfig(n_layer=sp.n_layer, n_embd=sp.n_embd, vocab_size=sp.vocab_size)
    state0 = multihost.local_batch(init_state(cfg, (B,), device=dev), mesh, dim=1)
    graphs_mod.set_counts([0] * len(graphs_mod.COUNTERS))
    mesh.reset_collectives()
    state, got = ShardedState.cut(state0, mesh), []
    for tok in [tokens] + fed:
        logits, state = step(sp, tok.to(torch.int64), state)
        got.append(logits)
    collectives = dict(mesh.collectives)
    vocab = int(ref["vocab"])  # the padded ids' -1e9 bias would swamp the scale
    errs = [_errs(g[:, :vocab], w[:, :vocab]) for g, w in zip(got, want)]
    scaled = max(e[1] for e in errs)
    if scaled > TOL:
        raise SystemExit(f"pod_worker: body {body}: scaled error {scaled:.3e} > {TOL} "
                         f"against the reference (per step {errs})")
    gens = [torch.Generator(device=dev).manual_seed(1000 * mesh.first_row + i)
            for i in range(tokens.shape[0])]
    logits, trace = got[-1], []
    for _ in range(SAMPLED_STEPS):
        ids = mesh.group_broadcast(typical(logits, gens, temp=0.9, tau=0.8))
        trace.append(ids)
        logits, state = step(sp, ids, state)
    _sync(dev)
    launches = _counts()
    if not torch.isfinite(logits).all():
        raise SystemExit(f"pod_worker: body {body}: non-finite logits after sampling")
    trace = torch.stack(trace)  # [3, b]
    if not ((trace >= 0) & (trace < vocab)).all():
        raise SystemExit(f"pod_worker: body {body}: sampled ids outside the vocab: {trace}")
    joined = multihost.global_batch(trace, dim=1, mesh=mesh)  # [3, B], every row's streams
    b = trace.shape[1]
    start = mesh.first_row * (b // mesh.local_rows)
    if not torch.equal(joined[:, start:start + b], trace):
        raise SystemExit(f"pod_worker: body {body}: global_batch put this process's ids "
                         f"elsewhere: {joined} against {trace}")
    rec = {"B": B, "max_abs_err": max(e[0] for e in errs), "max_scaled_err": scaled,
           "launches": launches, "collectives": collectives, "steps": len(got),
           "graphed": step.graphed, "replays": step.graphs.replays if step.graphs else 0,
           "sampled": joined.tolist(), "checksum": float(logits[:, :vocab].abs().sum())}
    if body == "fused" and dev.type == "cuda" and mesh.spans_processes:
        rec["flags"] = check_flags(sp, mesh, tokens.shape[0], launches)
    if time_steps and dev.type == "cuda":
        tok = trace[-1]
        _barrier()  # every process times at once
        rec["ms_per_step"], state = _ms_per_step(step, sp, tok, state, time_steps)
        if step.graphed:  # the eager body and the graph, in turns
            rec["ms_eager"], rec["ms_graphed"] = [], []
            for _ in range(2):
                for key, fn in (("ms_eager", step.eager), ("ms_graphed", step)):
                    _barrier()
                    ms, state = _ms_per_step(fn, sp, tok, state, time_steps)
                    rec[key].append(ms)
        if not mesh.spans_processes:
            pid = multihost.process_index()
            for p in range(multihost.process_count()):  # then each alone
                _barrier()
                if p == pid:
                    rec["ms_per_step_alone"], state = _ms_per_step(step, sp, tok, state,
                                                                   time_steps)
        _barrier()
    return rec, torch.stack(got)


def expect_refused(body: str, sp, mesh, ref) -> str:
    """The message with which make_tp_step(body), or its first step on
    the reference's tokens, raises; exits if neither does."""
    dev = mesh.first_device
    tokens = multihost.local_batch(torch.as_tensor(ref["tokens"], device=dev), mesh)
    cfg = RWKVConfig(n_layer=sp.n_layer, n_embd=sp.n_embd, vocab_size=sp.vocab_size)
    state = ShardedState.cut(multihost.local_batch(
        init_state(cfg, (ref["tokens"].shape[0],), device=dev), mesh, dim=1), mesh)
    try:
        step = make_tp_step(mesh, sp, body=body)
        step(sp, tokens.to(torch.int64), state)
    except (ValueError, RuntimeError, TypeError) as e:
        return str(e)
    raise SystemExit(f"pod_worker: body {body} was not refused on this mesh")


def check_flags(sp, mesh, B: int, launches: dict) -> list:
    """K7's flag words on this card after the body's steps (graph replays
    included): the step counter at the launches made, each shard's
    embedding flag at that count N and its att and ffn flags at N * L."""
    n = launches["decode_stack_tp.launches"] + launches["decode_stack_tp.launches_q4"]
    words = k7.flag_words(sp.rows[0], B, mesh).tolist()
    tp, L = mesh.shape["model"], sp.n_layer
    want = {0: n}
    for j in range(tp):
        want.update({16 + j: n, 16 + 8 + j: n * L, 16 + 16 + j: n * L})
    bad = {i: (words[i], w) for i, w in want.items() if words[i] != w}
    if bad:
        raise SystemExit(f"pod_worker: K7's flag words after {n} steps: (got, want) {bad}")
    return [words[i] for i in sorted(want)]


def k7_check(sp, mesh, ref, steps: int = 2) -> dict:
    """Kernel K7 across processes against its plain version on the same
    inputs (this process's shard, the reference's first tokens then its
    ids): logits and states at K7_TOL; one launch a step in this process;
    on CUDA, the ms a step of K7 and of its plain version ("ms",
    "plain_ms")."""
    dev = mesh.first_device
    tokens = multihost.local_batch(torch.as_tensor(ref["tokens"], device=dev), mesh)
    fed = [multihost.local_batch(torch.as_tensor(i, device=dev), mesh) for i in ref["ids"]]
    B = ref["tokens"].shape[0]
    cfg = RWKVConfig(n_layer=sp.n_layer, n_embd=sp.n_embd, vocab_size=sp.vocab_size)
    st = ShardedState.cut(multihost.local_batch(init_state(cfg, (B,), device=dev), mesh,
                                                dim=1), mesh).cells[0]
    st_p = st
    local = [sp.local(0, j) for j in range(mesh.local_shards)]
    worst, launched = (0.0, 0.0), 0
    for i, tok in enumerate(([tokens] + fed)[:steps]):
        tok = tok.to(torch.int64)
        before = k7.launches + k7.launches_q4
        lg_k, n_k = k7.decode_stack_tp(sp.rows[0], st, local, token=tok, mesh=mesh)
        launched += k7.launches + k7.launches_q4 - before
        lg_p, n_p = k7.decode_stack_tp_reference(sp.rows[0], st_p, local, token=tok, mesh=mesh)
        pairs = [("logits", a, b) for a, b in zip(lg_k, lg_p)]
        pairs += [(n, a, b) for c_k, c_p in zip(n_k, n_p)
                  for n, a, b in zip(WKVState._fields, c_k, c_p)]
        for name, a, b in pairs:
            if not torch.isfinite(a).all():
                raise SystemExit(f"pod_worker: K7 step {i}: {name} not finite")
            e = _errs(a, b)
            if e[1] > K7_TOL:
                raise SystemExit(f"pod_worker: K7 across processes step {i}: {name} scaled "
                                 f"error {e[1]:.3e} > {K7_TOL} against its plain version")
            worst = max(worst, e)
        st, st_p = n_k, n_p
    _sync(dev)
    if dev.type == "cuda" and launched != steps:
        raise SystemExit(f"pod_worker: K7 across processes launched {launched} times in "
                         f"{steps} steps, want one a step in this process")
    rec = {"B": B, "max_abs_err": worst[0], "max_scaled_err": worst[1], "launches": launched}
    if dev.type == "cuda":  # ms a step, every process timing at once: K7, then its plain version
        for key, fn in (("ms", k7.decode_stack_tp), ("plain_ms", k7.decode_stack_tp_reference)):
            _barrier()
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(K7_TIMED):
                fn(sp.rows[0], st, local, token=tok, mesh=mesh)
            _sync(dev)
            rec[key] = (time.perf_counter() - t0) * 1e3 / K7_TIMED
    return rec


def write_engine_reference(path: str, out: str, device, steps: int = ENGINE_STEPS):
    """The one-device engine on a .bin (K1 + K2 on CUDA): for each of
    PROMPTS, the logits after load_context and after each of `steps` greedy
    steps ([steps + 1, V] each, as "logits<i>"), and "vocab"."""
    from rwkv_tpu_torch.runtime.engine import RWKV

    eng = RWKV(path, device=device)
    eng.load_tokenizer(native=False)
    V = eng._true_vocab
    arrays = {"vocab": V}
    for i, prompt in enumerate(PROMPTS):
        eng.reset_state()
        eng.load_context(prompt)
        traj = [eng._last_logits[0][:V].clone()]
        for _ in range(steps):
            eng.forward(int(traj[-1].argmax()))
            traj.append(eng._last_logits[0][:V].clone())
        arrays[f"logits{i}"] = torch.stack(traj).cpu().numpy()
    np.savez(out, **arrays)


def engine_check(bin_path: str, mesh, ref_path: str):
    """(record, (engine, pool)): RWKV(bin_path, sharding=mesh) in every
    process, the same calls: the
    logits of write_engine_reference's prompts and greedy steps at TOL, the
    greedy ids the reference's wherever its top-two gap exceeds TOL; then 3
    generate calls at tau = 0 and an InferencePool over the engine's sharded
    params (8 slots, 12 requests at tau = 0), every text the same in every
    process and, on CUDA, the engine's generate of the same request. On the
    CPU the matmuls' rounding depends on the batch width and the host's
    threads, and typical's pick at tau = 0 among 50k random logits can turn
    on it, so the CPU test holds these texts against the JAX engine's only
    up to its first near tie, and against a one-process run of the same
    calls."""
    from rwkv_tpu_torch.runtime.engine import RWKV
    from rwkv_tpu_torch.runtime.pool import InferencePool

    dev = mesh.first_device
    eng = RWKV(bin_path, sharding=mesh)
    eng.load_tokenizer(native=False)
    with np.load(ref_path) as z:
        refs = [z[f"logits{i}"] for i in range(len(PROMPTS))]
        V = int(z["vocab"])
    graphs_mod.set_counts([0] * len(graphs_mod.COUNTERS))
    worst, ties, ids = (0.0, 0.0), 0, []
    for prompt, ref in zip(PROMPTS, refs):
        eng.reset_state()
        eng.load_context(prompt)
        ids.append([])
        for want in torch.from_numpy(ref).to(dev)[:-1]:
            got = eng._last_logits[0][:V]
            e = _errs(got, want)
            if e[1] > TOL:
                raise SystemExit(f"pod_worker: engine logits scaled error {e[1]:.3e} > {TOL}")
            worst = max(worst, e)
            top2 = torch.topk(want.double(), 2).values
            gap = (top2[0] - top2[1]).item() / max(1.0, want.abs().max().item())
            if gap > TOL and int(got.argmax()) != int(want.argmax()):
                raise SystemExit(f"pod_worker: engine greedy id {int(got.argmax())}, the "
                                 f"reference's {int(want.argmax())} (gap {gap:.2e})")
            ties += gap <= TOL
            ids[-1].append(int(got.argmax()))
            eng.forward(int(want.argmax()))
    refused = None
    if mesh.spans_processes:  # the state's other shards are in other processes
        try:
            eng.get_state(0)
        except RuntimeError as e:
            refused = str(e)
        else:
            raise SystemExit("pod_worker: get_state across processes did not raise")
    texts = []
    for i, prompt in enumerate(PROMPTS):
        eng.reset_state()
        texts.append(eng.generate(prompt, max_tokens=GENERATE_TOKENS, temp=1.0, tau=0.0,
                                  seed=i))
    engine_launches = _counts()
    pool = InferencePool(eng.params, eng.tokenizer, max_streams=8, prefill_bucket=32,
                         step_fn=eng._step_fn, prefill_fn=eng._prefill_impl)
    reqs = pool_requests()
    graphs_mod.set_counts([0] * len(graphs_mod.COUNTERS))
    rids = [pool.submit(p, max_tokens=n, temp=t, tau=0.0, seed=s) for p, n, t, s in reqs]
    t0 = time.perf_counter()
    out = pool.run()
    pool_s = time.perf_counter() - t0
    pool_launches = _counts()
    if sorted(out) != sorted(rids):
        raise SystemExit("pod_worker: the pool lost a request")
    pool_texts = [out[r] for r in rids]
    if dev.type == "cuda":  # see the docstring
        for rid, (p, n, t, s) in zip(rids, reqs):
            eng.reset_state()
            want = eng.generate(p, max_tokens=n, temp=t, tau=0.0, seed=s)
            if out[rid] != want:
                raise SystemExit(f"pod_worker: pool request {rid}: {out[rid]!r}, the engine "
                                 f"gives {want!r}")
    everyone: list = [None] * multihost.process_count()
    dist.all_gather_object(everyone, (texts, pool_texts))
    if any(e != everyone[0] for e in everyone):
        raise SystemExit("pod_worker: the processes returned different texts")
    return {"body": eng._step_fn.body, "graphed": eng._graphs.enabled,
            "replays": eng._graphs.replays + pool._graphs.replays,
            "max_abs_err": worst[0], "max_scaled_err": worst[1], "ties": ties,
            "greedy_ids": ids, "get_state_refused": refused, "texts": texts,
            "pool_texts": pool_texts, "pool_s": pool_s,
            "engine_launches": engine_launches, "pool_launches": pool_launches}, (eng, pool)


def write_reference(source, out: str, device, tokens=(3, 150, 7, 299), steps: int = 3):
    """The reference .npz of a .bin (or of whole params, already on
    `device`): the single-process unsharded step (forward_step_fused: K1 +
    K2 on CUDA, their plain versions on the CPU) on len(tokens) streams from
    init_state, then `steps` steps fed its greedy ids. Returns the logits
    [steps + 1, B, Vp]."""
    from rwkv_tpu_torch.io.binfmt import read_bin, read_header
    from rwkv_tpu_torch.ops.cuda.decode_stack import forward_step_fused

    if isinstance(source, str):
        vocab = read_header(source).vocab_size
        params = read_bin(source, device, pad_vocab_to=512, signed=True)  # the engine's load
    else:
        params = source
        vocab = int((params.logit_bias == 0).sum()) if params.logit_bias is not None else \
            params.emb.shape[0]
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
    ap.add_argument("--params", required=True,
                    help=".bin, an .npz of a params tree, or random:<L>x<E>:<seed>")
    ap.add_argument("--ref", nargs="+", help="single-process reference .npz files")
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
    ap.add_argument("--bodies", nargs="*", default=["fused", "halves"])
    ap.add_argument("--expect-refused", nargs="*", default=[], metavar="BODY",
                    help="bodies whose make_tp_step must raise on this mesh")
    ap.add_argument("--k7-check", action="store_true",
                    help="K7 across processes against its plain version")
    ap.add_argument("--engine-ref", default=None,
                    help="check the engine and the pool against this write_engine_reference")
    ap.add_argument("--time-steps", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=60.0, help="seconds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.write_ref:
        write_reference(args.params, args.write_ref,
                        torch.device(args.devices[0] if args.devices else "cuda"))
        return 0
    if not args.ref and not args.engine_ref:
        ap.error("--ref or --engine-ref (or --write-ref) is required")
    devices = args.devices
    if devices is None and "LOCAL_RANK" in os.environ:
        devices = multihost.local_devices(args.cards)

    multihost.initialize(args.coordinator, args.processes, args.process_id,
                         backend=args.backend, timeout=args.timeout)
    try:
        P, pid = multihost.process_count(), multihost.process_index()
        if (args.processes, args.process_id) not in ((None, None), (P, pid)):
            raise SystemExit(f"pod_worker: joined as process {pid} of {P}")
        if devices is not None and torch.device(devices[0]).type == "cuda":
            torch.cuda.set_device(torch.device(devices[0]))
        mesh = multihost.pod_mesh("slice" if args.model is None else args.model, devices)
        dev = mesh.first_device
        tp = mesh.shape["model"]
        n_local = mesh.local_rows * mesh.local_shards
        want = {"data": P * n_local // tp, "model": tp}
        if mesh.shape != want:
            raise SystemExit(f"pod_worker: mesh {mesh.shape}, want {want}")

        per_row = tp // mesh.local_shards
        one = torch.full((mesh.local_rows,), float(pid + 1), device=dev)
        psum = multihost.psum_data(one, mesh)
        want_psum = sum(p + 1 for p in range(0, P, per_row))
        if not torch.all(psum == want_psum):
            raise SystemExit(f"pod_worker: psum over data gave {psum.tolist()}, "
                             f"want {want_psum}")

        t0 = time.perf_counter()
        sp = load_params(args.params, mesh)
        load_s = time.perf_counter() - t0
        refs = []
        for path in args.ref or ():
            with np.load(path) as z:
                refs.append({k: z[k] for k in z.files})

        refused = {body: expect_refused(body, sp, mesh, refs[0]) for body in args.expect_refused}

        bodies, logits, k7_recs = {}, {}, []
        for body in args.bodies:
            for r, ref in enumerate(refs):
                key = body if r == 0 else f"{body} B={ref['tokens'].shape[0]}"
                bodies[key], got = run_body(body, sp, mesh, ref, args.time_steps)
                if r == 0:
                    logits[body] = got
                sums = multihost.process_allgather(torch.tensor(
                    [bodies[key]["checksum"]], dtype=torch.float64, device=dev)).reshape(-1)
                if sums.shape != (P,) or not torch.isfinite(sums).all() \
                        or sums[pid].item() != bodies[key]["checksum"]:
                    raise SystemExit(f"pod_worker: body {body}: checksum allgather gave "
                                     f"{sums.tolist()}")
                bodies[key]["checksums"] = sums.tolist()
        if args.k7_check:
            k7_recs = [k7_check(sp, mesh, ref) for ref in refs]
        engine, held = None, None
        if args.engine_ref:
            del sp
            # the engine and the pool are held through the shutdown: it frees
            # their graphs (and the NCCL collectives captured in them) all the same
            engine, held = engine_check(args.params, mesh, args.engine_ref)
        if args.out:
            np.savez(args.out, **{b: lg.cpu().numpy() for b, lg in logits.items()})
        group = mesh.model_group
        rec = {
            "process": pid, "processes": P, "backend": dist.get_backend(),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "mesh": mesh.shape, "local_rows": mesh.local_rows, "first_row": mesh.first_row,
            "local_shards": mesh.local_shards, "first_shard": mesh.first_shard,
            "group": None if group is None else {
                "backend": dist.get_backend(group),
                "ranks": dist.get_process_group_ranks(group)},
            "psum": psum.tolist(), "load_s": load_s, "bodies": bodies, "refused": refused,
            "k7": k7_recs, "engine": engine, **(_shard_record(sp) if not args.engine_ref
                                                else {})}
        rec["open_handles"] = k7.open_handles()
        multihost.shutdown()  # the graphs freed, K7's regions closed and freed, the group left
        rec["open_handles_after"] = k7.open_handles()
        del held
        print(json.dumps(rec), flush=True)
        print(f"POD_WORKER_OK {pid}", flush=True)
    finally:
        if dist.is_initialized():  # a failed run leaves without the shutdown's barriers
            graphs_mod.release_all()
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
