"""Tensor parallelism across distinct GPUs, driven end to end and timed.

    python -m rwkv_tpu_torch.tools.tp_cards [--seed 0] [--out tp_cards.json] [--only-g [engine]]

Needs two or more CUDA devices of one host with peer access between them
(four H100s for every part); with fewer it exits 2 and says why. It runs, with n the cards it sees and
tp = min(n, 4) for the 14B parts:

  (a) kernel K7 across cards (each shard on its own card, one cooperative
      launch per card a step, the exchanges peer stores over NVLink)
      against its plain version, decode_stack_tp_reference, run on copies of
      the same shards on card 0: 430M shard widths at tp = 2 and 4, q8 and
      q4, B in {1, 8}, 2 carried steps, then RWKV-4 14B widths (L = 40, E =
      5120, F = 20480, V = 50277 padded by tp_vocab_multiple(tp), weights
      from random_quantized_params_np, seed 0) q8 at B in {1, 8}: logits and
      states at a scaled error <= 1e-4, one launch per card a step;
  (b) the tensor-parallel step over the cards (make_tp_step on a
      make_mesh(model=tp) of distinct cards, the state a resident
      ShardedState) at 14B widths, bodies "fused" (K7 across cards),
      "halves" (K6 + K2 on each card) and "plain", against the whole model
      at tp = 1 on card 0 (K1 + K2; if K1 refuses the width, the plain step,
      and the line says which), 4 steps fed the same ids, B in {1, 8}:
      logits at the TP pin (3e-4, scaled); per step K7 tp launches, K6 2 + 2
      a layer per card and K2 one per card, collectives 3 L + 2 for halves
      and plain, one gather for fused; each body one CUDA graph across the
      cards (runtime/graphs.py), its first call eager then captured, the
      other three replays, each step held against the eager body on a copy
      of the state (bit-equal, or the difference printed and held to the
      pin);
  (c) RWKV(path, sharding=make_mesh(model=tp)) on a 430M .bin written here
      (random weights, as chip_smoke.py's phase 4 writes it) answers 3
      requests (load_context, then greedy steps through forward, then
      generate) beside the one-card engine (K1 + K2): its logits at the TP
      pin, its greedy ids the one-card engine's wherever that engine's top
      two logits differ by more than the pin; no whole-state cut or join
      (sharding.counts) while it decodes; generate decodes from CUDA graphs
      across the cards (replays counted) and gives the texts of the same
      calls run eagerly; save_state -> load_state gives the state and
      logits back bit for bit;
  (d) InferencePool over that engine's sharded params, 8 slots, 12
      requests at tau = 0, its decode one CUDA graph across the cards:
      every text equal to the engine's generate for the same request, no
      whole-state cut or join;
  (e) pods with NCCL between the processes (tools/pod_worker.py): two
      processes of n / 2 cards each (pod_mesh(model="slice") = {"data": 2,
      "model": n / 2}, K7 across each process's cards), then n processes of
      one card each ({"data": n, "model": 1}); each holds its logits to the
      single-process reference at 3e-4 and allgathers its checksum;
  (f) timings, host-timed over back-to-back steps (every card
      synchronized), in turns with tp = 1 on card 0: the 14B and 430M step
      (body "fused", from its CUDA graph across the cards) at tp = 1, 2 and
      4, ms/step and ms/token, B in {1, 8} (430M q8 also B = 4); the
      exchanges' share of a 14B tp step from K7's %globaltimer stamps (each
      card's wait for its peers' flags, from the barrier to the wait's end,
      over the launch), eager; one psum and one gather of [B, E] over the
      cards by device copies and by the mesh's NCCL collectives; the 14B
      step at tp = 4 of each body (fused, halves, plain), B in {1, 8},
      replayed from its CUDA graph across the cards and run eagerly, in
      turns;
  (g) a model axis across processes (tools/pod_worker.py under
      pod_mesh(model=tp)): tp processes of one card each, NCCL between them,
      at 14B widths (each process makes the seed's weights and keeps its
      shard): bodies "fused" (K7 across processes: one launch a process a
      step, the exchanges peer stores into regions opened through CUDA IPC),
      "halves" and "plain" at B in {1, 8}, 4 steps then 3 sampled, against
      K1 + K2 on card 0 at the TP pin; K7 against its plain version on the
      same inputs at 1e-4; each process's step replayed from its own CUDA
      graph (the row's NCCL collectives inside it), its flag words at the
      steps made, and its eager body and graph timed in turns, ms/step and
      ms/token, and K7's and its plain version's ms a step; then, on the
      430M .bin, K7 against its plain version (4 streams, the same checks
      and times), and the engine and an 8-slot pool of 12 requests in every
      process, as in (c) and (d), each process still holding its engine
      and pool when it leaves the group (--only-g engine: this half alone).

Every figure line names the card (nvidia-smi's name and power limit); the
P2P matrix of the cards comes first. The last lines: one JSON object of the
figures, then TP_CARDS_OK. `run()` is what chip_smoke.py's phase 18 calls;
it returns the same record, with each kernel's launches on (b)-(d) (the
steps, the engine and the pool over the cards, counted from 0 around each;
the one-card references they are held against not counted).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.rwkv4 import (
    WKVState,
    forward_step,
    init_state,
    params_to,
    q4_pack_block,
    random_quantized_params_np,
    signedize_params,
)
from rwkv_tpu_torch.ops.cuda import decode_stack as ds_mod
from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
from rwkv_tpu_torch.ops.quant import Quant4Linear
from rwkv_tpu_torch.parallel import sharding
from rwkv_tpu_torch.parallel.mesh import make_mesh
from rwkv_tpu_torch.parallel.sharding import (
    ShardedState,
    shard_params,
    shard_state,
    tp_vocab_multiple,
)
from rwkv_tpu_torch.parallel.tp_step import make_tp_step
from rwkv_tpu_torch.runtime import graphs as graphs_mod

K7_TOL = 1e-4   # K7 against its plain version, as on one card
TP_TOL = 3e-4   # a tensor-parallel step against the unsharded one
PEAK_BYTES_PER_S = 3.35e12  # one H100 SXM's device memory rate (NVIDIA data sheet)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROMPTS = ("The quick brown fox", "Once upon a time, in a land far away,",
           "def fibonacci(n):\n")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"tp_cards: FAILED: {msg}")


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return "[card: nvidia-smi unavailable]"
    return "[" + (out[0] if out else "?") + f", x{len(out)}]"


def scaled_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, that over max(1, max |b|)), a moved to b's device."""
    a, b = a.to(b.device).double(), b.double()
    d = (a - b).abs().max().item()
    return d, d / max(1.0, b.abs().max().item())


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def host_ms(fn, n: int, warmup: int = 2) -> float:
    """ms per call of fn over n back-to-back calls, every card synchronized."""
    for _ in range(warmup):
        fn()
    sync_all()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync_all()
    return (time.perf_counter() - t0) * 1e3 / n


def launch_counts() -> dict:
    return {f"{m.__name__.rsplit('.', 1)[1]}.{a}": getattr(m, a)
            for m, a in graphs_mod.COUNTERS}


def set_launches_zero() -> None:
    graphs_mod.set_counts([0] * len(graphs_mod.COUNTERS))


def weight_bytes(p) -> int:
    """Bytes of a params tree's quantized weights (all families + head)."""
    n = 0
    for lin in (p.att.key, p.att.value, p.att.receptance, p.att.output, p.ffn.key,
                p.ffn.value, p.ffn.receptance, p.head):
        w = lin.wp if isinstance(lin, Quant4Linear) else lin.w
        n += w.numel() * w.element_size()
    return n


def p2p_matrix(n: int) -> list:
    """cudaDeviceCanAccessPeer for every ordered pair of the n cards."""
    return [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n)]
            for i in range(n)]


def topo() -> str:
    try:
        return subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                              timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "(nvidia-smi topo -m unavailable)"


# -- (a) K7 across cards against its plain version -------------------------------


def check_k7_cards(host, cfg, tp, batches, tag, rng, card, steps=2):
    """K7 over cards 0..tp-1 against decode_stack_tp_reference on copies of
    the shards on card 0; returns the worst (abs, scaled) error."""
    dev0 = torch.device("cuda", 0)
    mesh = make_mesh(model=tp, devices=[torch.device("cuda", i) for i in range(tp)])
    sp = shard_params(host, mesh)
    ref = [params_to(p, dev0) for p in sp.rows[0]]
    local = [sp.local(0, j) for j in range(tp)]
    local_ref = [(d.to(dev0), b.to(dev0)) for d, b in local]
    worst = (0.0, 0.0)
    for B in batches:
        st_k = shard_state(init_state(cfg, (B,), device=dev0), mesh)[0]
        st_p = [WKVState(*(t.to(dev0) for t in c)) for c in st_k]
        for step in range(steps):
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev0)
            before = k7.launches + k7.launches_q4
            lg_k, n_k = k7.decode_stack_tp(sp.rows[0], st_k, local, token=tok)
            require(k7.launches + k7.launches_q4 == before + tp,
                    f"K7 {tag} tp={tp} B={B}: {k7.launches + k7.launches_q4 - before} "
                    f"launches for the step, want one per card ({tp})")
            lg_p, n_p = k7.decode_stack_tp_reference(ref, st_p, local_ref, token=tok)
            pairs = [(f"logits[{j}]", lg_k[j], lg_p[j]) for j in range(tp)]
            pairs += [(f"{n}[{j}]", a, b) for j in range(tp)
                      for n, a, b in zip(WKVState._fields, n_k[j], n_p[j])]
            for j in range(tp):
                require(lg_k[j].device == torch.device("cuda", j),
                        f"K7 {tag}: shard {j}'s logits on {lg_k[j].device}")
            for name, a, b in pairs:
                require(bool(torch.isfinite(a).all()), f"K7 {tag} tp={tp} B={B} step {step}: "
                        f"{name} not finite")
                e = scaled_err(a, b)
                require(e[1] <= K7_TOL, f"K7 {tag} tp={tp} B={B} step {step}: {name} scaled "
                        f"error {e[1]:.3e} > {K7_TOL}")
                worst = max(worst, e)
            st_k, st_p = n_k, n_p
    print(f"  (a) K7 across cards {tag} tp={tp} (E/tp={cfg.n_embd // tp}), B in {batches}, "
          f"{steps} steps: max abs err {worst[0]:.3e} (scaled {worst[1]:.2e} <= {K7_TOL}), "
          f"one launch per card a step {card}")
    del ref
    return worst, sp


# -- (b) the step over cards against tp = 1 on card 0 --------------------------------


def unsharded_step(whole):
    """The tp = 1 reference on card 0: K1 + K2 (forward_step_fused), or, if
    K1 refuses the width, the plain step. Returns (step, which)."""
    cfg = whole.config
    st = init_state(cfg, (1,), device=whole.emb.device)
    tok = torch.zeros(1, dtype=torch.int64, device=whole.emb.device)
    try:
        ds_mod.forward_step_fused(whole, tok, st)
        torch.cuda.synchronize(whole.emb.device)
        return ds_mod.forward_step_fused, "K1 + K2 on card 0"
    except (RuntimeError, ValueError) as e:
        return forward_step, f"the plain step on card 0 (K1 refused: {e})"


def check_bodies(whole, sp, cfg, rng, card, steps=4, batches=(1, 8)):
    """Each body over the cards against the unsharded step on card 0."""
    mesh = sp.mesh
    tp, L, V = mesh.shape["model"], cfg.n_layer, 50277
    ref_step, which = unsharded_step(whole)
    dev0 = whole.emb.device
    out, total, vs = {}, {}, {}
    for B in batches:
        toks = [torch.from_numpy(rng.integers(0, V, size=(B,))).to(dev0) for _ in range(steps)]
        st = init_state(cfg, (B,), device=dev0)
        want = []
        for tok in toks:
            lg, st = ref_step(whole, tok, st)
            want.append(lg[:, :V])
        for body in ("fused", "halves", "plain"):
            step = make_tp_step(mesh, sp, body=body)
            require(step.body == body and step.graphed,
                    f"asked for body {body}, graphed, got {step.body}, graphed {step.graphed}")
            state = ShardedState.zeros(cfg, B, mesh)
            state_e = state.with_leaves([t.clone() for t in state])
            worst, vs_eager = (0.0, 0.0), 0.0
            for i, tok in enumerate(toks):
                set_launches_zero()
                mesh.reset_collectives()
                cuts = dict(sharding.counts)
                lg, state = step(sp, tok, state)
                torch.cuda.synchronize(dev0)
                got = launch_counts()
                coll = dict(mesh.collectives)
                require(sharding.counts == cuts, f"body {body}: the state was cut or joined "
                        f"({cuts} -> {sharding.counts})")
                e = scaled_err(lg[:, :V], want[i])
                require(e[1] <= TP_TOL, f"body {body} tp={tp} B={B} step {i}: scaled error "
                        f"{e[1]:.3e} > {TP_TOL} against {which}")
                worst = max(worst, e)
                lg_e, state_e = step.eager(sp, tok, state_e)
                sync_all()
                d = max([scaled_err(lg, lg_e)[1]]
                        + [scaled_err(a, b)[1] for a, b in zip(state, state_e)])
                require(d <= TP_TOL, f"body {body} tp={tp} B={B} step {i}: graphed against "
                        f"eager, scaled difference {d:.3e} > {TP_TOL}")
                vs_eager = max(vs_eager, d)
                if body == "fused":
                    exp = {"decode_stack_tp.launches": tp}
                    exp_coll = {"psum": 0, "all_gather": 1} if B <= k7.FUSE_EMBED_MAX_B else \
                        {"psum": 1, "all_gather": 1}
                elif body == "halves":
                    exp = {"tp_halves.launches_att": 2 * L * tp,
                           "tp_halves.launches_ffn": 2 * L * tp, "mm8.launches": tp}
                    exp_coll = {"psum": 2 * L + 1, "all_gather": L + 1}
                else:
                    exp = {}
                    exp_coll = {"psum": 2 * L + 1, "all_gather": L + 1}
                nz = {k: v for k, v in got.items() if v}
                require(nz == exp, f"body {body} tp={tp} B={B}: launches {nz}, want {exp}")
                for k, v in got.items():
                    total[k] = total.get(k, 0) + v
                require(coll == exp_coll, f"body {body} tp={tp} B={B}: collectives {coll}, "
                        f"want {exp_coll}")
            require(step.graphs.replays == steps - 1 and len(step.graphs) == 1,
                    f"body {body} B={B}: {step.graphs.replays} replays of {len(step.graphs)} "
                    f"graphs, want {steps - 1} of 1")
            out[body, B] = worst
            vs[body, B] = vs_eager
            print(f"  (b) 14B tp={tp} body {body} B={B}, {steps} steps fed the same ids: max abs "
                  f"err {worst[0]:.3e} (scaled {worst[1]:.2e} <= {TP_TOL}) against {which}; "
                  f"one graph across the cards, {step.graphs.replays} replays, against the "
                  f"eager body: "
                  f"{'bit-equal' if vs_eager == 0 else f'scaled difference {vs_eager:.2e}'}; "
                  f"per step launches {exp or 'none'}, collectives {exp_coll} {card}")
    return out, which, total, vs


# -- (c), (d) the engine and the pool over the cards ---------------------------------


def check_engine(bin_path, tp, card):
    """RWKV(path, sharding=make_mesh(model=tp)) beside the one-card engine."""
    from rwkv_tpu_torch.runtime.engine import RWKV

    eng1 = RWKV(bin_path)
    eng1.load_tokenizer(native=False)
    mesh = make_mesh(model=tp, devices=[torch.device("cuda", i) for i in range(tp)])
    eng = RWKV(bin_path, sharding=mesh)
    eng.load_tokenizer(native=False)
    require(eng._step_fn.body == "fused" and eng._graphs.enabled and eng._step_fn.graphed,
            f"the engine over cards runs body {eng._step_fn.body}, graphs "
            f"{eng._graphs.enabled}, step graphed {eng._step_fn.graphed}; want fused, graphed")
    V = eng._true_vocab
    worst, ties, steps, per_token_cuts = (0.0, 0.0), 0, 16, 0
    # the one-card engine's greedy trajectories first, so that the launches
    # counted below are the engine's over the cards alone
    refs = []
    for prompt in PROMPTS:
        eng1.reset_state()
        eng1.load_context(prompt)
        refs.append([eng1._last_logits[0][:V].clone()])
        for _ in range(steps):
            eng1.forward(int(refs[-1][-1].argmax()))
            refs[-1].append(eng1._last_logits[0][:V].clone())
    del eng1
    set_launches_zero()
    for prompt, ref in zip(PROMPTS, refs):
        eng.reset_state()
        eng.load_context(prompt)
        for want in ref[:steps]:
            got = eng._last_logits[0][:V]
            e = scaled_err(got, want)
            require(e[1] <= TP_TOL, f"engine over {tp} cards: logits scaled error {e[1]:.3e}")
            worst = max(worst, e)
            top2 = torch.topk(want.double(), 2).values
            gap = (top2[0] - top2[1]).item() / max(1.0, want.abs().max().item())
            if gap > TP_TOL:
                require(int(got.argmax()) == int(want.argmax()),
                        f"engine over {tp} cards: greedy id {int(got.argmax())}, the one-card "
                        f"engine's {int(want.argmax())} (top-two gap {gap:.2e})")
            else:
                ties += 1
            cuts = dict(sharding.counts)
            eng.forward(int(want.argmax()))
            per_token_cuts += sum(sharding.counts.values()) - sum(cuts.values())
    require(per_token_cuts == 0, f"engine over cards: {per_token_cuts} whole-state cuts or "
            "joins while decoding")
    engine_launches = launch_counts()
    texts = []
    replays = eng._graphs.replays
    for i, prompt in enumerate(PROMPTS):
        eng.reset_state()
        cuts = dict(sharding.counts)
        texts.append(eng.generate(prompt, max_tokens=24, temp=1.0, tau=0.0, seed=i,
                                  chunk=1 + 7 * (i % 2)))
        require(sharding.counts == cuts, "engine.generate over cards cut or joined the state")
    replays = eng._graphs.replays - replays
    require(replays > 0, "engine.generate over cards replayed no graph")
    eng._graphs.enabled = eng._step_fn.graphs.enabled = False
    for i, (prompt, want) in enumerate(zip(PROMPTS, texts)):
        eng.reset_state()
        got = eng.generate(prompt, max_tokens=24, temp=1.0, tau=0.0, seed=i,
                           chunk=1 + 7 * (i % 2))
        require(got == want, f"engine over cards: eager text {got!r}, graphed {want!r}")
    eng._graphs.enabled = eng._step_fn.graphs.enabled = True
    # save_state -> load_state, bit for bit
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "s.npz")
        before = eng.get_state(0)
        logits = eng._last_logits.get(0)
        eng.save_state(path, 0)
        eng.reset_state()
        eng.load_state(path, 0)
        after = eng.get_state(0)
        require(all(torch.equal(a, b) for a, b in zip(before, after)),
                "save_state -> load_state changed the state")
        if logits is not None:
            require(torch.equal(eng._last_logits[0][:V], logits[:V]),
                    "save_state -> load_state changed the logits")
    print(f"  (c) engine over {tp} cards, 3 requests x {steps} greedy steps: logits max abs err "
          f"{worst[0]:.3e} (scaled {worst[1]:.2e} <= {TP_TOL}), greedy ids equal the one-card "
          f"engine's at every step whose top-two gap exceeds the pin ({ties} within it); 0 "
          f"state cuts or joins per token; save/load_state bit for bit; generate from "
          f"graphs across the cards ({replays} replays, {len(eng._graphs)} graphs), the "
          f"eager texts: {[t[:24] for t in texts]!r} {card}")
    return eng, worst, engine_launches


def check_pool(eng, card):
    """InferencePool over the engine's sharded params against the engine."""
    from rwkv_tpu_torch.runtime.pool import InferencePool

    pool = InferencePool(eng.params, eng.tokenizer, max_streams=8, prefill_bucket=32,
                         step_fn=eng._step_fn, prefill_fn=eng._prefill_impl)
    reqs = [(PROMPTS[i % 3] + " " * (i // 3), 12 + i, 0.7 + 0.05 * i, i) for i in range(12)]
    set_launches_zero()
    cuts = dict(sharding.counts)
    rids = [pool.submit(p, max_tokens=n, temp=t, tau=0.0, seed=s) for p, n, t, s in reqs]
    t0 = time.perf_counter()
    out = pool.run()
    pool_s = time.perf_counter() - t0
    require(sharding.counts == cuts, f"the pool cut or joined the state: {cuts} -> "
            f"{sharding.counts}")
    pool_launches = launch_counts()
    require(sorted(out) == sorted(rids), "the pool lost a request")
    require(len(pool._graphs) == 1 and pool._graphs.replays > 0,
            f"the pool over cards made {len(pool._graphs)} graphs, {pool._graphs.replays} "
            f"replays; want its decode from one graph across the cards")
    for rid, (p, n, t, s) in zip(rids, reqs):
        eng.reset_state()
        want = eng.generate(p, max_tokens=n, temp=t, tau=0.0, seed=s)
        require(out[rid] == want, f"pool request {rid}: {out[rid]!r}, the engine gives "
                f"{want!r}")
    print(f"  (d) pool over {eng._mesh.shape['model']} cards: 8 slots, 12 requests at tau=0 in "
          f"{pool_s:.2f} s, every text the engine's; 0 state cuts or joins; its decode one "
          f"graph across the cards, {pool._graphs.replays} replays; K7 launches "
          f"{pool_launches['decode_stack_tp.launches']} {card}")
    return pool_launches


# -- (e) pods on NCCL --------------------------------------------------------------


def run_pods(bin_path, n, card, tmp):
    """Two processes of n / 2 cards, then n processes of one card, NCCL."""
    from rwkv_tpu_torch.tools import pod_worker

    ref = os.path.join(tmp, "ref.npz")
    pod_worker.write_reference(bin_path, ref, torch.device("cuda", 0))
    recs = {}
    for procs in (2, n):
        per = n // procs
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        ps = [subprocess.Popen(
            [sys.executable, "-m", "rwkv_tpu_torch.tools.pod_worker", "--params", bin_path,
             "--ref", ref, "--coordinator", f"127.0.0.1:{port}", "--processes", str(procs),
             "--process-id", str(i), "--backend", "nccl", "--devices",
             *[f"cuda:{i * per + k}" for k in range(per)], "--model", str(per),
             "--bodies", "fused", "halves", "--time-steps", "20", "--timeout", "120"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(procs)]
        outs = []
        try:
            for p in ps:
                outs.append(p.communicate(timeout=400)[0])
        finally:
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        got = []
        for i, (p, o) in enumerate(zip(ps, outs)):
            require(p.returncode == 0 and f"POD_WORKER_OK {i}" in o,
                    f"pod worker {i} of {procs} exited {p.returncode}:\n{o[-4000:]}")
            got.append(json.loads(next(ln for ln in o.splitlines() if ln.startswith("{"))))
        steps = 4 + pod_worker.SAMPLED_STEPS
        for r in got:
            require(r["backend"] == "nccl" and r["mesh"] == {"data": procs, "model": per},
                    f"pod worker {r['process']}: {r['backend']}, mesh {r['mesh']}")
            k7n = r["bodies"]["fused"]["launches"]["decode_stack_tp.launches"]
            require(k7n == steps * per, f"pod worker {r['process']}: {k7n} K7 launches, want "
                    f"{steps * per} ({steps} steps, one per card)")
            require(len(r["bodies"]["fused"]["checksums"]) == procs, "checksums not gathered")
        errs = max(r["bodies"][b]["max_scaled_err"] for r in got for b in r["bodies"])
        recs[f"{procs}x{per}"] = {
            "max_scaled_err": errs,
            "ms_per_step": {b: [r["bodies"][b]["ms_per_step"] for r in got]
                            for b in ("fused", "halves")},
            "launches_fused": [r["bodies"]["fused"]["launches"]["decode_stack_tp.launches"]
                               for r in got]}
        print(f"  (e) pod of {procs} processes x {per} card(s) on NCCL: mesh "
              f"{got[0]['mesh']}, scaled error <= {errs:.2e} (pin {pod_worker.TOL}); ms/step "
              f"with every process timing: fused {recs[f'{procs}x{per}']['ms_per_step']['fused']}"
              f", halves {recs[f'{procs}x{per}']['ms_per_step']['halves']}; checksums "
              f"{got[0]['bodies']['fused']['checksums']} {card}")
    return recs


# -- (g) a model axis across processes ---------------------------------------------


def _spawn(tp, args_of, timeout):
    """tp pod_worker processes on one NCCL job, process i on cuda:i; their
    records (raising on any failure). A process that fails fails the job at
    once: the others, which would wait on it in a collective, are stopped
    with SIGABRT (with Python's fault handler on, each prints where it
    waited), as is every process still running after `timeout` seconds."""
    import signal
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTHONFAULTHANDLER"] = "1"
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(tp)]
    ps = [subprocess.Popen(
        [sys.executable, "-m", "rwkv_tpu_torch.tools.pod_worker", "--coordinator",
         f"127.0.0.1:{port}", "--processes", str(tp), "--process-id", str(i), "--backend",
         "nccl", "--devices", f"cuda:{i}", "--model", str(tp), "--timeout", "300",
         *args_of(i)], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
        for i, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in ps):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in ps):
                break
            time.sleep(0.5)
    finally:
        stopped = [p for p in ps if p.poll() is None]
        for p in stopped:
            p.send_signal(signal.SIGABRT)
        for p in stopped:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    got = []
    for i, (p, o) in enumerate(zip(ps, outs)):
        require(p.returncode == 0 and f"POD_WORKER_OK {i}" in o,
                f"(g) pod worker {i} of {tp} exited {p.returncode}"
                f"{' (stopped)' if p in stopped else ''}:\n{o[-6000:]}"
                + "".join(f"\n--- worker {k}, rc {q.returncode}:\n{outs[k][-3000:]}"
                          for k, q in enumerate(ps) if k != i))
        got.append(json.loads(next(ln for ln in o.splitlines() if ln.startswith("{"))))
    print(json.dumps(got))  # every process's record, before any check reads it
    return got


def run_pod_model(host14, seed, bin_path, tp, card, tmp):
    """(g): tp processes of one card each, pod_mesh(model=tp), at 14B
    widths, then the engine and the pool on the 430M .bin."""
    from rwkv_tpu_torch.tools import pod_worker

    dev0 = torch.device("cuda", 0)
    cfg14 = host14.config
    L = cfg14.n_layer
    whole = params_to(host14, dev0)
    rng = np.random.default_rng(seed + 7)
    refs = []
    for B in (1, 8):
        refs.append(os.path.join(tmp, f"ref14_{B}.npz"))
        tokens = tuple(int(t) for t in rng.integers(0, 50277, size=B))
        pod_worker.write_reference(whole, refs[-1], dev0, tokens=tokens)
    del whole
    torch.cuda.empty_cache()
    spec = f"random:{L}x{cfg14.n_embd}:{seed}"
    t0 = time.perf_counter()
    got = _spawn(tp, lambda i: ["--params", spec, "--ref", *refs, "--bodies", "fused",
                                "halves", "plain", "--k7-check", "--time-steps", "20"], 1500)
    secs = time.perf_counter() - t0
    steps = 4 + pod_worker.SAMPLED_STEPS
    out: dict = {"seconds": secs, "bodies": {}, "k7": {}}
    for r in got:
        require(r["group"] == {"backend": "nccl", "ranks": list(range(tp))}
                and r["local_shards"] == 1 and r["first_shard"] == r["process"],
                f"(g) process {r['process']}: group {r['group']}, shard {r['first_shard']}")
        for k in r["k7"]:
            require(k["max_scaled_err"] <= K7_TOL and k["launches"] == 2,
                    f"(g) process {r['process']}: K7 against its plain version {k}")
        for key, b in r["bodies"].items():
            body = key.split()[0]
            require(b["max_scaled_err"] <= TP_TOL, f"(g) {key}: scaled error "
                    f"{b['max_scaled_err']:.3e} against K1 + K2 on card 0")
            require(b["graphed"] and b["replays"] == steps - 1,
                    f"(g) {key}: graphed {b['graphed']}, {b['replays']} replays, want "
                    f"{steps - 1}")
            want = {"fused": {"decode_stack_tp.launches": steps},
                    "halves": {"tp_halves.launches_att": 2 * L * steps,
                               "tp_halves.launches_ffn": 2 * L * steps,
                               "mm8.launches": steps},
                    "plain": {}}[body]
            nz = {k: v for k, v in b["launches"].items() if v}
            require(nz == want, f"(g) {key} process {r['process']}: launches {nz}, want {want}")
            if body != "fused":
                require(b["collectives"] == {"psum": (2 * L + 1) * b["steps"],
                                             "all_gather": (L + 1) * b["steps"]},
                        f"(g) {key}: collectives {b['collectives']}")
        # a region a batch size (B = 1 and 8), each process's opened in the others
        require(r["open_handles"] == 2 * (tp - 1) and r["open_handles_after"] == 0,
                f"(g) process {r['process']}: IPC handles {r['open_handles']} open, "
                f"{r['open_handles_after']} after shutdown, want {2 * (tp - 1)} and 0")
    for key in got[0]["bodies"]:
        rows = [r["bodies"][key] for r in got]
        B = rows[0]["B"]
        out["bodies"][key] = {
            "max_scaled_err": max(x["max_scaled_err"] for x in rows),
            "ms_per_step": [x["ms_per_step"] for x in rows],
            "ms_eager": [x["ms_eager"] for x in rows],
            "ms_graphed": [x["ms_graphed"] for x in rows],
            "replays": rows[0]["replays"],
            "launches_per_process": {k: v for k, v in rows[0]["launches"].items() if v}}
        e, gph = max(min(x["ms_eager"]) for x in rows), max(min(x["ms_graphed"]) for x in rows)
        print(f"  (g) 14B across {tp} processes, body {key.split()[0]} B={B}: scaled err <= "
              f"{out['bodies'][key]['max_scaled_err']:.2e} (pin {TP_TOL}) against K1 + K2 on "
              f"card 0; graphed ({rows[0]['replays']} replays) in turns with eager, slowest "
              f"process: eager {e:.3f} ms/step ({e / B:.3f} ms/token), graphed {gph:.3f} "
              f"ms/step ({gph / B:.3f} ms/token); per process "
              f"{out['bodies'][key]['launches_per_process'] or 'no kernel launches'} {card}")
    out["k7"] = _k7_across(got)
    out["flags"] = {k: got[0]["bodies"][k].get("flags") for k in got[0]["bodies"]
                    if k.startswith("fused")}
    print(f"  (g) K7 across {tp} processes at 14B widths against its plain version: "
          f"{out['k7']} (scaled error <= {K7_TOL}; ms a step of K7 and of its plain version, "
          f"slowest process, every process timing at once), one launch a process a step; "
          f"flag words on card 0 after the "
          f"fused steps {out['flags']}; every process closed its {got[0]['open_handles']} "
          f"peer regions before the regions were freed; {secs:.0f} s {card}")
    out["launches"] = {k: sum(r["bodies"][b]["launches"][k] for r in got for b in r["bodies"])
                       for k in got[0]["bodies"]["fused"]["launches"]}

    for k, v in run_pod_engine(bin_path, tp, card, tmp, out).items():
        out["launches"][k] += v
    return out


def _k7_across(got) -> dict:
    """K7 across processes per reference batch, from every process's
    --k7-check record: the largest scaled error against the plain version,
    and the slowest process's ms a step of each."""
    return {f"B={k['B']}": {key: max(r["k7"][i][key] for r in got)
                            for key in ("max_scaled_err", "ms", "plain_ms")}
            for i, k in enumerate(got[0]["k7"])}


def run_pod_engine(bin_path, tp, card, tmp, out, timeout=900):
    """(g)'s second half, in tp processes of one card each on the 430M
    .bin: K7 across processes against its plain version (4 streams), then
    the engine and the pool, which every process still holds when it
    leaves; fills out["engine"] and out["k7_430m"] and returns the
    processes' kernel launches."""
    from rwkv_tpu_torch.tools import pod_worker

    dev0 = torch.device("cuda", 0)
    eng_ref = os.path.join(tmp, "eng_ref.npz")
    ref = os.path.join(tmp, "ref430.npz")
    pod_worker.write_engine_reference(bin_path, eng_ref, dev0)
    pod_worker.write_reference(bin_path, ref, dev0)
    torch.cuda.empty_cache()
    eng = _spawn(tp, lambda i: ["--params", bin_path, "--ref", ref, "--k7-check",
                                "--engine-ref", eng_ref, "--bodies"], timeout)
    out["k7_430m"] = _k7_across(eng)
    for r in eng:
        for k in r["k7"]:
            require(k["max_scaled_err"] <= K7_TOL and k["launches"] == 2,
                    f"(g) 430M process {r['process']}: K7 against its plain version {k}")
        require(r["open_handles_after"] == 0,
                f"(g) engine process {r['process']}: {r['open_handles_after']} IPC handles "
                f"open after shutdown")
    print(f"  (g) K7 across {tp} processes at 430M widths against its plain version: "
          f"{out['k7_430m']} (scaled error <= {K7_TOL}; ms a step, slowest process) {card}")
    e0 = eng[0]["engine"]
    for r in eng:
        e = r["engine"]
        require(e["body"] == "fused" and e["graphed"],
                f"(g) engine process {r['process']}: body {e['body']}, graphed {e['graphed']}")
        require(e["max_scaled_err"] <= TP_TOL, f"(g) engine logits {e['max_scaled_err']:.3e}")
        require("spans processes" in (e["get_state_refused"] or ""), "(g) get_state")
    out["engine"] = {"max_scaled_err": max(r["engine"]["max_scaled_err"] for r in eng),
                     "ties": e0["ties"], "replays": e0["replays"], "pool_s": e0["pool_s"],
                     "engine_launches": e0["engine_launches"],
                     "pool_launches": e0["pool_launches"]}
    launches = {k: sum(r["engine"]["engine_launches"][k] + r["engine"]["pool_launches"][k]
                       for r in eng) for k in e0["engine_launches"]}
    print(f"  (g) engine over {tp} processes (body {e0['body']}, graphed, {e0['replays']} "
          f"replays in process 0), 3 requests x {pod_worker.ENGINE_STEPS} greedy steps: "
          f"logits scaled err <= {out['engine']['max_scaled_err']:.2e} against the one-card "
          f"engine, greedy ids equal wherever the top-two gap exceeds the pin ({e0['ties']} "
          f"within it); generate texts equal in every process: {[t[:24] for t in e0['texts']]!r}; "
          f"pool of 8 slots, 12 requests at tau=0 in {e0['pool_s']:.2f} s, every text the "
          f"engine's and the same in every process; K7 launches in process 0: engine "
          f"{e0['engine_launches']['decode_stack_tp.launches']}, pool "
          f"{e0['pool_launches']['decode_stack_tp.launches']}; every process left the group "
          f"holding its engine and pool (their graphs freed by multihost.shutdown) {card}")
    return launches


# -- (f) timings ---------------------------------------------------------------------


def exchange_share(sp, cfg, B, tok_dev0, n=5):
    """The exchanges' share of a K7 step over the cards, from its stamps:
    per card, the time from each exchange's barrier to the end of its wait
    (the embedding exchange from the launch's start), over the launch."""
    mesh, L = sp.mesh, cfg.n_layer
    tp = mesh.shape["model"]
    local = [sp.local(0, j) for j in range(tp)]
    st = shard_state(init_state(cfg, (B,), device=tok_dev0.device), mesh)[0]
    stamps = [torch.zeros(6 * L + 3, dtype=torch.int64, device=torch.device("cuda", j))
              for j in range(tp)]
    shares, totals = [], []
    for _ in range(n):
        k7.decode_stack_tp(sp.rows[0], st, local, token=tok_dev0, stamps=stamps)
        sync_all()
        for t in stamps:
            s = t.cpu().tolist()
            total = s[4 * L + 1] - s[0]
            wait = s[4 * L + 2] - s[0]
            for l in range(L):
                wait += s[4 * L + 3 + 2 * l] - s[1 + 4 * l + 1]  # after B(l)'s barrier
                wait += s[4 * L + 4 + 2 * l] - s[1 + 4 * l + 3]  # after D(l)'s barrier
            shares.append(wait / total)
            totals.append(total / 1e6)
    return float(np.median(shares)), float(np.median(totals))


def time_steps(host, cfg, tps, tag, card, rng, batches=(1, 8), n=20):
    """ms/step of the fused step at each tp over cards 0..tp-1, and of the
    unsharded step (K1 + K2) on card 0 as tp = 1, in turns."""
    dev0 = torch.device("cuda", 0)
    whole = params_to(host, dev0)
    steps = {1: (lambda tok, st: ds_mod.forward_step_fused(whole, tok, st))}
    meshes, sps = {}, {}
    for tp in tps:
        mesh = make_mesh(model=tp, devices=[torch.device("cuda", i) for i in range(tp)])
        sp = shard_params(host, mesh)
        step = make_tp_step(mesh, sp, body="fused")
        meshes[tp], sps[tp] = mesh, sp
        steps[tp] = (lambda tok, st, step=step, sp=sp: step(sp, tok, st))
    rows = {}
    for B in batches:
        tok = torch.from_numpy(rng.integers(0, 50277, size=(B,))).to(dev0)
        states = {1: init_state(cfg, (B,), device=dev0)}
        for tp in tps:
            states[tp] = ShardedState.zeros(cfg, B, meshes[tp])
        order = [1] + list(tps) + list(reversed(tps)) + [1]
        t = {tp: [] for tp in [1] + list(tps)}
        for tp in order:
            st = states[tp]
            t[tp].append(host_ms(lambda: steps[tp](tok, st), n))  # noqa: B023
        for tp, v in t.items():
            rows[tp, B] = min(v)
        print(f"  (f) {tag} fused step B={B}, in turns " + ", ".join(
            f"tp={tp} {', '.join(f'{x:.3f}' for x in v)} ms/step "
            f"({min(v) / B:.3f} ms/token)" for tp, v in t.items()) + f" {card}")
    return rows, sps, whole


def plain_times(sps, cfg, tag, card, n=3):
    """ms of K7's plain version (decode_stack_tp_reference) at B = 1 for each
    tp's shards, copied to card 0."""
    dev0 = torch.device("cuda", 0)
    out = {}
    for tp, sp in sps.items():
        ref = [params_to(p, dev0) for p in sp.rows[0]]
        local = [tuple(v.to(dev0) for v in sp.local(0, j)) for j in range(tp)]
        st = [WKVState(*(t.to(dev0) for t in c))
              for c in shard_state(init_state(cfg, (1,), device=dev0), sp.mesh)[0]]
        tok = torch.zeros(1, dtype=torch.int64, device=dev0)
        out[tp] = host_ms(lambda: k7.decode_stack_tp_reference(  # noqa: B023
            ref, st, local, token=tok), n, warmup=1)
        del ref
    print(f"  (f) {tag} K7's plain version on card 0, B=1: "
          + ", ".join(f"tp={tp} {v:.3f} ms" for tp, v in out.items()) + f" {card}")
    return out


def _copies_psum(row, dev0):
    """The psum by device copies: summed on dev0 in shard order, then
    copied back out to each shard's card (the measurement that set the
    mesh's choice of NCCL)."""
    s = row[0]
    for p in row[1:]:
        s = s + p.to(dev0)
    return [s.to(p.device) for p in row]


def _copies_gather(row, dev0):
    g = torch.cat([p.to(dev0) for p in row], dim=-1)
    return [g.to(p.device) for p in row]


def collective_times(E, tp, card, n=50):
    """One psum and one gather of [B, E] f32 over cards 0..tp-1: device
    copies against the mesh's NCCL collectives."""
    cards = [torch.device("cuda", i) for i in range(tp)]
    mesh = make_mesh(model=tp, devices=cards)
    out = {}
    for B in (1, 8):
        parts = [torch.randn(B, E, device=d) for d in cards]
        gparts = [torch.randn(B, E // tp, device=d) for d in cards]
        out["copies", "psum", B] = host_ms(lambda: _copies_psum(parts, cards[0]), n)  # noqa: B023
        out["copies", "gather", B] = host_ms(lambda: _copies_gather(gparts, cards[0]), n)  # noqa: B023,E501
        out["nccl", "psum", B] = host_ms(lambda: mesh.psum([parts]), n)  # noqa: B023
        out["nccl", "gather", B] = host_ms(lambda: mesh.all_gather([gparts]), n)  # noqa: B023
    print(f"  (f) collectives over {tp} cards, [B, {E}] f32 psum / [B, {E // tp}] gather, "
          f"ms: " + "; ".join(f"{x} {k} B={b} {v:.4f}" for (x, k, b), v in out.items())
          + f" {card}")
    return out


def body_times(sp, cfg, card, batches=(1, 8), n=20):
    """ms/step of the 14B step over the cards for each body (fused, halves,
    plain), replayed from its CUDA graph across the cards and run eagerly, in
    turns (graphed, eager, eager, graphed)."""
    mesh = sp.mesh
    tp = mesh.shape["model"]
    out = {}
    for body in ("fused", "halves", "plain"):
        step = make_tp_step(mesh, sp, body=body)
        require(step.graphed, f"(f) body {body} over the cards is not graphed")
        for B in batches:
            st = ShardedState.zeros(cfg, B, mesh)
            tok = torch.zeros(B, dtype=torch.int64, device=mesh.first_device)
            runs = {"graphed": lambda: step(sp, tok, st),  # noqa: B023
                    "eager": lambda: step.eager(sp, tok, st)}  # noqa: B023
            t = {"graphed": [], "eager": []}
            for mode in ("graphed", "eager", "eager", "graphed"):
                reps = max(3, n // 4) if (body, mode) == ("plain", "eager") else n
                t[mode].append(host_ms(runs[mode], reps))
            out[body, B] = t
            print(f"  (f) 14B tp={tp} body {body} B={B}, in turns: graphed "
                  f"{', '.join(f'{x:.3f}' for x in t['graphed'])} ms/step, eager "
                  f"{', '.join(f'{x:.3f}' for x in t['eager'])} ms/step "
                  f"({min(t['graphed']) / B:.3f} / {min(t['eager']) / B:.3f} ms/token) {card}")
        del step
    return out


# -- the run ---------------------------------------------------------------------------


def run(seed: int = 0, bin_path: str | None = None) -> dict:
    """Everything above; returns the record (the kernels' launches on
    (b)-(d) under "launches")."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        raise SystemExit(2)
    card = card_name()
    tp_max = min(n, 4)
    tps = [t for t in (2, 4) if t <= tp_max]
    print(f"tp_cards: {n} cards {card}; P2P (cudaDeviceCanAccessPeer): {p2p_matrix(n)}")
    print(topo())
    rng = np.random.default_rng(seed)
    rec: dict = {"cards": n, "card": card, "p2p": p2p_matrix(n)}
    t_start = time.perf_counter()
    from rwkv_tpu_torch.ops.cuda import _build

    secs = _build.build(("decode_stack", "decode_stack_tp", "tp_halves", "mm8"))
    print(f"  build: {', '.join(f'{k} {v:.0f} s' for k, v in secs.items())}")

    # (a) 430M shard widths, q8 and q4
    cfg430 = RWKVConfig(n_layer=24, n_embd=1024)
    q8 = signedize_params(params_to(random_quantized_params_np(
        cfg430, seed=seed + 1, pad_multiple=tp_vocab_multiple(4)), "cpu"))
    q4 = params_to(random_quantized_params_np(cfg430, seed=seed + 2,
                                              pad_multiple=tp_vocab_multiple(4), q4=True,
                                              q4_block=q4_pack_block(1024, 4)), "cpu")
    rec["a"] = {}
    for tp in tps:
        for tag, host in (("430M q8", q8), ("430M q4", q4)):
            rec["a"][f"{tag} tp={tp}"] = check_k7_cards(host, cfg430, tp, (1, 8), tag, rng,
                                                         card)[0]
    # 14B widths
    cfg14 = RWKVConfig(n_layer=40, n_embd=5120)
    t0 = time.perf_counter()
    host14 = signedize_params(params_to(random_quantized_params_np(
        cfg14, seed=seed, pad_multiple=tp_vocab_multiple(tp_max)), "cpu"))
    print(f"  14B params: {weight_bytes(host14) / 1e9:.2f} GB of q8 weights, made in "
          f"{time.perf_counter() - t0:.1f} s")
    worst14, sp14 = check_k7_cards(host14, cfg14, tp_max, (1, 8), "14B q8", rng, card)
    rec["a"][f"14B q8 tp={tp_max}"] = worst14

    # (b) the bodies over the cards against tp = 1 on card 0
    whole14 = params_to(host14, torch.device("cuda", 0))
    bodies, which, launches_b, vs_eager = check_bodies(whole14, sp14, cfg14, rng, card)
    rec["b"] = {f"{b} B={B}": v for (b, B), v in bodies.items()}
    rec["b_graphed_vs_eager"] = {f"{b} B={B}": v for (b, B), v in vs_eager.items()}
    rec["b_reference"] = which
    del whole14

    # (c), (d) the engine and the pool on a 430M .bin
    from rwkv_tpu_torch.io.binfmt import write_bin

    tmp = tempfile.TemporaryDirectory(dir=_build.BUILD_DIR)
    bin_path = bin_path or os.path.join(tmp.name, "m430.bin")
    if not os.path.exists(bin_path):
        write_bin(bin_path, random_quantized_params_np(cfg430, seed=seed + 3))
    eng, worst_eng, launches_c = check_engine(bin_path, tp_max, card)
    rec["c"] = worst_eng
    launches_d = check_pool(eng, card)
    del eng
    torch.cuda.empty_cache()
    rec["launches"] = {k: launches_b[k] + launches_c[k] + launches_d[k] for k in launches_b}

    # (e) pods on NCCL
    rec["e"] = run_pods(bin_path, 2 * (n // 2) if n < 4 else 4, card, tmp.name)

    # (g) a model axis across processes, one card a process
    if n >= 2:
        rec["g"] = run_pod_model(host14, seed, bin_path, tp_max, card, tmp.name)

    # (f) timings
    bound = {}
    for tp in [1] + tps:
        per_card = weight_bytes(host14) / tp
        bound[tp] = per_card / PEAK_BYTES_PER_S * 1e3
    rows14, sps, whole = time_steps(host14, cfg14, tps, "14B", card, rng)
    rec["f_14b"] = {f"tp={tp} B={B}": v for (tp, B), v in rows14.items()}
    rec["f_14b_bound_ms_per_card"] = bound
    share, total = exchange_share(sps[tp_max], cfg14, 1,
                                  torch.zeros(1, dtype=torch.int64, device="cuda:0"))
    rec["f_14b_exchange_share"] = {"share": share, "launch_ms": total}
    print(f"  (f) 14B tp={tp_max} K7 step B=1: exchanges (each card's waits for its peers' "
          f"flags) {share:.1%} of the {total:.3f} ms launch (median over cards and 5 steps); "
          f"bound per card {bound[tp_max]:.3f} ms (q8 weight bytes / 3.35 TB/s) {card}")
    rec["f_14b_bodies"] = {f"{b} B={B}": v for (b, B), v in
                           body_times(sps[tp_max], cfg14, card).items()}
    del sps, whole
    torch.cuda.empty_cache()
    rec["f_collectives"] = {f"{x} {k} B={b}": v
                            for (x, k, b), v in collective_times(5120, tp_max, card).items()}
    rows430, sps430, _ = time_steps(q8, cfg430, tps, "430M", card, rng, batches=(1, 4, 8))
    rec["f_430m"] = {f"tp={tp} B={B}": v for (tp, B), v in rows430.items()}
    rec["f_430m_plain"] = plain_times(sps430, cfg430, "430M q8", card)
    rows430q4, sps430q4, _ = time_steps(q4, cfg430, tps, "430M q4", card, rng)
    rec["f_430m_q4"] = {f"tp={tp} B={B}": v for (tp, B), v in rows430q4.items()}
    rec["f_430m_q4_plain"] = plain_times(sps430q4, cfg430, "430M q4", card)
    if "g" in rec:  # the launches of (g)'s processes with (b)-(d)'s
        for k, v in rec["g"]["launches"].items():
            rec["launches"][k] += v
    rec["seconds"] = time.perf_counter() - t_start
    tmp.cleanup()
    return rec


def run_g(seed: int = 0, part: str = "all") -> dict:
    """(g) alone: the 14B weights, the 430M .bin, then run_pod_model; part
    "engine": the 430M .bin and run_pod_engine only."""
    from rwkv_tpu_torch.io.binfmt import write_bin
    from rwkv_tpu_torch.ops.cuda import _build

    n = torch.cuda.device_count()
    card = card_name()
    tp = min(n, 4)
    print(f"tp_cards (g): {n} cards {card}; P2P (cudaDeviceCanAccessPeer): {p2p_matrix(n)}")
    secs = _build.build(("decode_stack", "decode_stack_tp", "tp_halves", "mm8"))
    print(f"  build: {', '.join(f'{k} {v:.0f} s' for k, v in secs.items())}")
    tmp = tempfile.TemporaryDirectory(dir=_build.BUILD_DIR)
    bin_path = os.path.join(tmp.name, "m430.bin")
    write_bin(bin_path, random_quantized_params_np(RWKVConfig(n_layer=24, n_embd=1024),
                                                   seed=seed + 3))
    if part == "engine":
        g: dict = {}
        g["launches"] = run_pod_engine(bin_path, tp, card, tmp.name, g, timeout=300)
    else:
        host14 = signedize_params(params_to(random_quantized_params_np(
            RWKVConfig(n_layer=40, n_embd=5120), seed=seed, pad_multiple=tp_vocab_multiple(tp)),
            "cpu"))
        g = run_pod_model(host14, seed, bin_path, tp, card, tmp.name)
    rec = {"cards": n, "card": card, "g": g}
    tmp.cleanup()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the record as JSON here")
    ap.add_argument("--only-g", nargs="?", const="all", choices=("all", "engine"),
                    help="run part (g) alone (a model axis across processes); "
                    "--only-g engine: its engine and pool half")
    args = ap.parse_args(argv)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"tp_cards: did not run: {n} CUDA device(s); tensor parallelism across cards "
              "needs two or more")
        return 2
    rec = run_g(args.seed, args.only_g) if args.only_g else run(args.seed)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    print(json.dumps(rec, default=str))
    print("TP_CARDS_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
