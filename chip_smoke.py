#!/usr/bin/env python3
"""Smoke run of the rwkv_tpu_torch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and exits non-zero:

  1. device   nvidia-smi name + power limit; build every CUDA kernel from
              rwkv_tpu_torch/csrc (one nvcc per source, all at once); the
              CUDA runtime's and driver's versions; device memory bandwidth
              from a large device-to-device copy.
  2. mm8      kernel K2 against its plain version at the head shape
              [B, 1024] x [1024, 50688] int8, B in {1, 8}; times of the
              kernel (the median of repeated CUDA-graph replays, and called
              back to back from Python), the plain version and one
              torch.matmul on the widened weight (the yardstick, never used
              by the port).
  3. decode   kernel K1 (+ K2 head) against the plain version at RWKV-4 430M
              widths (L=24, E=1024, F=4096, Vp=50688), weights from a numpy
              seed, B in {1, 8, 16}, 4 consecutive steps: logits and all 5
              state tensors, one cooperative launch a step; ms per step, eager
              and replayed from a CUDA graph, against the weight-bytes bound.
  4. e2e      write a 430M .bin with the port's write_bin, load it with
              RWKV(path) on the default device, answer 3 requests
              (load_context + generate(max_tokens=32), temp, tau, ban and
              seed differing per request) with the decode replayed from CUDA
              graphs (runtime/graphs.py: the first id, then step + ban +
              typical per chunk), check that both kernels' launch counters
              rose, the stack's by one per decoded step; the same requests
              eagerly and at chunk 8, graphed and eager, give the same
              texts; decode ms/token graphed and eager at chunk 1 and 8 in
              turns, the device's busy share of generate (torch.profiler);
              the engine's logits match the plain model on the loaded
              weights; the graphs made and the shared graph pool's size;
              typical alone over [1, 50688] and [8, 50688] logits from a
              CUDA graph.
  5. mm4      kernel K3 against its plain version at the q4 head shape
              [B, 1024] x packed [512, 50688], B in {1, 8, 16}, and the same
              bits from a second call; how the kernel cuts the call; times of
              the kernel as graph-replay medians warm (one weight, L2-resident)
              and from HBM (the calls rotate over 6 copies of the weight, 156
              MB: as the q4 step's head finds it) and eager, of the plain
              version and of one torch.matmul on the pre-widened f32
              [1024, 50688] weight (the yardstick); the bound counts the
              tensor-core products the kernel issues (N = 3B rounded up to 8
              columns) at the bf16 peak.
  6. decode4  kernel K4 (+ K3 head) against the plain version at 430M widths
              with packed 4-bit weights from a numpy seed (the default pairing
              block, 1024), B in {1, 8, 16}, 4 steps, logits and all 5 state
              tensors; then at RWKV-4 7B widths (E=4096, F=16384, block 256)
              with L=2, where both row-tiled families pair within sub-K blocks.
  7. e2e4     write a 430M q4 artifact with the port's save_q4, load it with
              RWKV(path), check it runs as q4, answer 3 requests as phase 4
              does (graphed, against eager) and check the K4 (one per decoded
              step) and K3 launch counters rose and the logits match the
              plain model; then load a dense f32 .safetensors at 430M width
              (L=2) with RWKV(path, quant="q4") and decode a few tokens.
  8. mm8_a8   kernel K5's head (mm8_a8.cu) against its plain version at
              [B, 1024] x [1024, 50688] int8, B in {1, 8, 16}: the int8
              codes equal, the outputs within 1e-6 scaled; times of the
              kernel (graph-replay median and eager), the plain version and
              torch._int_mm (cuBLAS s8 x s8) on the same codes, rows padded
              to 24 (the yardstick).
  9. decode8  kernel K5's stack (the a8 branch of decode_stack.cu) + a8 head
              against the plain a8 version at 430M widths, a8_block 512, B in
              {1, 8, 16}, 4 carried steps: the state bit-equal, logits within
              A8_DECODE_TOL scaled, equal argmax, one stack launch a step; ms
              per step beside the q8 step (K1 + K2) at the same B, in turns.
 10. serve    the phase-4 .bin through RWKV(path), load_params(a8=True), and
              an 8-slot InferencePool on the engine's a8 step: 12 requests
              (prompts of 5-300 tokens, 16-64 new tokens, mixed temp/tau,
              stop strings); all must finish, K5's counters must rise and
              the q8 ones stay still; one request re-run alone in a fresh
              pool gives the same text; tok/s and ms per pool step at full
              occupancy; the pool's step_chunk steps replayed from a CUDA
              graph: the 12 texts equal an eager pool's, and step_chunk 4's
              graphed and eager; the a8 engine's requests as phase 4; then
              the first 8 requests at 32 tokens on the q8 step (K1 + K2) and
              the a8 step, graphed and eager, in turns.
 11. tp_halves kernel K6 (att_half + ffn_half, csrc/tp_halves.cu) against
              its plain versions at 430M shard widths, tp in {1, 2, 4} on a
              virtual mesh (one card named tp times: E/tp = 1024, 512, 256),
              B in {1, 8}, every layer index: partial, aa/bb/pp, gate and the
              new xy/dd within K6_TOL scaled, and the tp shards' partials
              summed in the fixed order against the tp = 1 call within
              K6_SUM_TOL; then 14B widths (E=5120, F=20480, L=2) at tp = 8
              (E/tp = 640). How each of the four launches (a1, a2, f1, f2) is
              cut: cluster size, blocks, shared memory, and one wave of
              co-resident clusters at 430M tp = 1. The same bits on two calls
              and from graph replays. Times at tp = 1: each half per layer
              over all L layers in turn from a CUDA graph (the weights from
              device memory, as a step reads them), beside the one-layer
              L2-hot figure, K1's per-layer share (phase 3) and the bound.
 12. tp serve the phase-4 .bin through RWKV(path, sharding=make_mesh(model=1),
              tp_body="halves"): 3 requests on the tensor-parallel step
              replayed from its CUDA graph (K6, 2 + 2 launches a layer: 4 * L
              a step; the head on K2), K6's and K2's counters rising and K1's
              and K7's still, the logits against the plain model, ms/token
              beside the K1 engine's; then on a virtual model=2 mesh
              (one card twice): logits within TP_TOL of tp = 1, the same 8
              greedy ids, 3L + 2 collectives a step; then a 4-slot
              InferencePool over it serving 6 requests, graphed, the texts
              equal to an eager pool's. The requests run graphed against
              eager as in phase 4. Times on a virtual mesh are correctness
              runs, not speed-ups.
 13. tp_fused kernel K7 (csrc/decode_stack_tp.cu: the whole step of a data
              row's shards as one cooperative launch) against its plain
              version at 430M widths, q8 and q4 (block 256, inside a shard up
              to tp = 4), tp in {1, 2, 4} on a virtual mesh, B in {1, 8} with
              the embedding gather in the step and B = 16 with x given, 2
              carried steps: one launch a step, every shard's logits and
              state within DECODE_TOL scaled; at tp = 1 against the unsharded
              step (K1 + K2, K4 + K3) on the same params, and the tp >= 2
              logits gathered against tp = 1; then 14B widths (E=5120,
              F=20480, L=2) at tp = 8 (and 1), q8 and q4 (block 128); ms per
              step at tp = 1 beside the unsharded step, in turns, eager and
              replayed from a CUDA graph.
 14. tp_fused serve  the phase-4 .bin through RWKV(path, sharding=
              make_mesh(model=1), tp_body="fused"): 3 requests on K7 alone
              (K6, K2 and K1 still), one K7 launch per decoded step, the
              logits against the plain model and
              the same greedy ids as the K1 engine; a virtual model=2 fused
              engine: the same 8 greedy ids, 1 gather and 0 psums a step; a
              4-slot pool over it serving 6 requests, graphed, the texts equal
              to an eager pool's; the requests run graphed against eager as
              in phase 4, and every engine's ms/token; then a q4 engine on a
              virtual model=2 mesh and an unsharded q4 engine fed the same
              4-bit params (block 512): the same greedy ids, on K7's q4
              instantiation.
 15. apps     the apps on the card, from the phase-4 .bin: one 512-token
              chunk of forward_seq(parallel=True) in f32 and bf16
              (compute_dtype), ms per chunk (median of 5), the bf16 logits'
              scaled error against f32 and each chunk's device time by op
              (tools/prefill_profile.py); the eval CLI (eval/cli.py) on
              README.md, 2,047 tokens, f32 and --bf16, |NLL(bf16) - NLL(f32)|
              < 0.05 and tokens/s; the HTTP server (apps/server.py
              make_server: --bf16-prefill --pool 8 --pool-chunk 4) on
              127.0.0.1:0 in a thread: /health, 8 concurrent /complete
              (prompts of 12-300 tokens, 32 new each: the pool's counters say
              8 x 32 tokens), a streaming /complete, a /tokenize round trip,
              /metrics, tok/s over all streams and ms per pool step, K1 and K2
              launched and no plain version called, then a drain; the same
              engine behind a server without --pool (generate); storygen
              (--stories 1 --max-tokens 32) and vectordb (--batch-index
              --bf16-prefill) through their main(argv).

 16. convert  a dense RWKV-4 430M checkpoint (BlinkDL names, bf16, from the
              port's init_params on a seeded generator) written as .pth and
              converted by `python -m rwkv_tpu_torch.io.convert` (its main) in
              a child process, to a q8 .bin and to a q4 artifact: seconds,
              input MB/s and the child's peak RSS (wait4, and sampled from
              /proc every 10 ms) beside the .pth's size and beside a child
              that only imports the converter; read_bin of the .bin equal to load_checkpoint_quantized of
              the .pth, leaf for leaf; RWKV on each answers 3 requests graphed
              (K1 + K2, then K4 + K3, one stack launch per decoded step; no
              plain version called) with its logits against the plain model;
              TorchRWKV over the .bin: 16 forward calls on K1 + K2 against the
              plain model, the state passed in unchanged, forward_batch (B=4)
              against single streams, its state in RWKV.set_state giving the
              engine's greedy ids; sample_logits (top_p 0.9, temp 0.7) over
              [8, 50688] engine logits: the CPU's kept set, the same draws
              from the same seed; the native tokenizer built with g++ (build
              seconds), README.md's ids and every id's bytes equal to the
              Python BPE's, encode tokens/s of both (host figures).

Then one JSON line listing the kernels, the card's name and power limit, and
last: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs CUDA: with no GPU, or outside a checkout of the repo, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from functools import partial

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# float32 rate outside the tensor cores (the kernels accumulate in f32 FMAs)
# and the dense bf16 tensor-core rate (K3's products).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12  # tensor cores, dense: the rate of W8A8's s8 x s8 products

# Tolerances, stated: fp32 sums over 1024..4096 terms in another order than
# torch.matmul's; scaled error = max|kernel - plain| / max(1, max|plain|).
MM8_TOL = 1e-5
MM4_TOL = 1e-5
DECODE_TOL = 1e-4
# W8A8: the kernel and the plain version quantize the same f32 numbers to
# equal codes and sum the integer products exactly, so mm8_a8 differs only
# in the f32 rounding of its per-group partial sums. The a8 stack repeats
# the plain version's arithmetic bit for bit up to every quantization
# (csrc/decode_stack.cu says how): at 430M one code one apart moves the
# logits by ~2e-2 a few layers on, so anything less gives no bound at all
# (PERF.md, the W8A8 findings). The state then matches exactly and the logits to the
# head's f32 rounding: K1's 1e-4 holds.
MM8_A8_TOL = 1e-6
A8_DECODE_TOL = 1e-4
# K6 against its plain version: one layer half, its matvecs' f32 sums in
# another order than torch.matmul's (the rank-1 offset terms in double on
# both sides). The shards' partials summed against the tp = 1 call: the
# partial sums of a contraction split over tp shards, then added, round
# differently from one contraction. A tensor-parallel engine against the
# tp = 1 one: tests/test_tp_step.py's pin.
K6_TOL = 1e-5
K6_SUM_TOL = 1e-4
TP_TOL = 3e-4


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false: no GPU")
    sys.path.insert(0, HERE)
    import rwkv_tpu_torch

    require(os.path.dirname(os.path.abspath(rwkv_tpu_torch.__file__)).startswith(HERE + os.sep),
            f"rwkv_tpu_torch comes from {rwkv_tpu_torch.__file__}, not this checkout")
    from rwkv_tpu_torch.io.binfmt import write_bin
    from rwkv_tpu_torch.io.q4fmt import save_q4
    from rwkv_tpu_torch.io.safetensors import write_safetensors
    from rwkv_tpu_torch.models.config import RWKVConfig
    from rwkv_tpu_torch.models.rwkv4 import (
        WKVState,
        a8_block_for,
        forward_step,
        init_state,
        map_params,
        params_to,
        q4_pack_block,
        random_quantized_params_np,
        signedize_params,
    )
    from rwkv_tpu_torch.ops.layernorm import layer_norm
    from rwkv_tpu_torch.ops.cuda import _build
    from rwkv_tpu_torch.ops.cuda import decode_stack as ds_mod
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
    from rwkv_tpu_torch.ops.cuda import mm4 as mm4_mod
    from rwkv_tpu_torch.ops.cuda import mm8 as mm8_mod
    from rwkv_tpu_torch.ops.cuda import tp_halves as th
    from rwkv_tpu_torch.ops.quant import Quant4Linear, unpack4
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import shard_params, shard_state
    from rwkv_tpu_torch.runtime.engine import RWKV
    from rwkv_tpu_torch.runtime.pool import InferencePool
    from rwkv_tpu_torch.ops.sampling import typical
    from rwkv_tpu_torch.runtime import graphs as graphs_mod
    from rwkv_tpu_torch.tools.halves_time import graph_median_ms, time_halves
    from torch.profiler import ProfilerActivity, profile
    from rwkv_tpu_torch.tools.head_time import cold_median_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ------------------------------------------------------------------ 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"phase 1 device: {smi}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"  kernel build: {time.perf_counter() - t0:.1f} s wall "
          + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()))
    for n in _build.KERNELS:  # each distinct report line once, with its count of kernels
        lines = [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
        for line in dict.fromkeys(lines):
            print(f"  ptxas {n}: {line} (x{lines.count(line)})")
    rt, drv = th.cuda_versions()
    print(f"  CUDA runtime {rt // 1000}.{rt % 1000 // 10}, driver {drv // 1000}.{drv % 1000 // 10} "
          "(K6's programmatic dependent launches inside a CUDA graph need 12.3)")

    def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def graph_ms(fn, iters: int, generators=()) -> float:
        """Device ms per call of fn, `iters` calls captured in one CUDA graph
        and replayed: the host's launch cost taken out. generators: those fn
        draws from."""
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        for gen in generators:
            g.register_generator_state(gen)
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    big = torch.empty(1 << 28, dtype=torch.float32, device=dev)  # 1 GiB
    dst = torch.empty_like(big)
    copy_ms = cuda_ms(lambda: dst.copy_(big), 10)
    bw = 2 * big.numel() * 4 / (copy_ms * 1e-3)
    del big, dst
    print(f"  device-to-device copy: {bw / 1e9:.1f} GB/s (read + write) {card}")

    def bound(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS):
        tb, to = nbytes / PEAK_BYTES_PER_S, flops / peak
        return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

    def scaled_err(a, b) -> tuple[float, float]:
        d = (a.double() - b.double()).abs().max().item()
        return d, d / max(1.0, b.double().abs().max().item())

    rng = np.random.default_rng(args.seed)
    cfg = RWKVConfig.rwkv4_430m()
    E, L, F = cfg.n_embd, cfg.n_layer, cfg.n_ffn

    # ------------------------------------------------------------------ 2
    print("phase 2 mm8 (K2) vs plain, [B, 1024] x [1024, 50688] int8")
    K, O = E, 50688
    w = torch.from_numpy(rng.integers(-128, 128, size=(K, O), dtype=np.int8)).to(dev)
    w_f32 = w.float()  # the yardstick's operand, prepared beforehand
    mm8_rows = {}
    for B in (1, 8):
        xs = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32) / 1000).to(dev)
        got = mm8_mod.mm8(xs, w)
        ref = mm8_mod.mm8_plain(xs, w)
        torch.cuda.synchronize()
        err, serr = scaled_err(got, ref)
        require(bool(torch.isfinite(got).all()), f"mm8 B={B}: non-finite output")
        require(serr <= MM8_TOL, f"mm8 B={B}: scaled error {serr:.3e} > {MM8_TOL}")
        eager_ms = cuda_ms(lambda: mm8_mod.mm8(xs, w), 50)
        ms = graph_median_ms(lambda: mm8_mod.mm8(xs, w), 50, 15)
        plain_ms = cuda_ms(lambda: mm8_mod.mm8_plain(xs, w), 20)
        lib_ms = cuda_ms(lambda: torch.matmul(xs, w_f32), 50)
        b_ms, b_by = bound(K * O + B * K * 4 + B * O * 4, 2 * B * K * O)
        bw_ms = K * O / bw * 1e3
        mm8_rows[B] = dict(err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, lib_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by)
        print(f"  B={B}: max abs err {err:.3e} (scaled {serr:.3e} <= {MM8_TOL}); "
              f"kernel {ms:.4f} ms (median of 15 CUDA-graph replays of 50 calls; "
              f"{eager_ms:.4f} called back to back from Python), plain {plain_ms:.4f} ms, "
              f"torch.matmul on widened W "
              f"{lib_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, published peaks), "
              f"{bw_ms:.4f} ms at the measured copy rate; {K * O / (ms * 1e-3) / 1e9:.0f} GB/s "
              f"of weights {card}")
    del w, w_f32

    # ------------------------------------------------------------------ 3
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731

    def weight_bytes(params):
        fams = (params.att.key, params.att.value, params.att.receptance, params.att.output,
                params.ffn.key, params.ffn.value, params.ffn.receptance)
        return nbytes(f.wp if isinstance(f, Quant4Linear) else f.w for f in fams)

    def vector_bytes(params):
        # every f32 vector the decode stack reads once: norms, mixes,
        # decay/bonus, scales/offsets
        leaves = []
        map_params(params, leaves.append)
        return nbytes(t for t in leaves if t.dtype == torch.float32 and t.dim() <= 2
                      and t is not params.emb and t is not params.logit_bias)

    def head_kernel(params, xh, oh):
        h = params.head
        if isinstance(h, Quant4Linear):
            return mm4_mod.mm4(xh, h.wp, block=h.block, row_add=oh, col_add=params.logit_bias)
        return mm8_mod.mm8(xh, h.w, row_add=oh, col_add=params.logit_bias)

    def head_plain(params, xh, oh):
        h = params.head
        if isinstance(h, Quant4Linear):
            return mm4_mod.mm4_plain(xh, h.wp, block=h.block, row_add=oh,
                                     col_add=params.logit_bias)
        return mm8_mod.mm8_plain(xh, h.w, row_add=oh, col_add=params.logit_bias)

    def check_decode(params, cfg_, tag, batches=(1, 8), steps=4, timed=True):
        """The decode stack + head kernels against the plain version over
        `steps` carried steps; returns {B: row of numbers}."""
        L_, E_ = cfg_.n_layer, cfg_.n_embd
        wb, vb = weight_bytes(params), vector_bytes(params)
        rows = {}
        for B in batches:
            st_k = init_state(cfg_, (B,), device=dev)
            st_p = init_state(cfg_, (B,), device=dev)
            worst = {}
            for step in range(steps):
                tok = torch.from_numpy(rng.integers(0, cfg_.vocab_size, size=(B,))).to(dev)
                before = ds_mod.launches + ds_mod.launches_q4
                y_k, n_k, xh_k, oh_k = ds_mod.decode_stack(params, tok, st_k)
                require(ds_mod.launches + ds_mod.launches_q4 == before + 1,
                        f"{tag} B={B}: the stack took more than one launch")
                lg_k = head_kernel(params, xh_k, oh_k)
                y_p, n_p, xh_p, oh_p = ds_mod.decode_stack_plain(params, tok, st_p)
                lg_p = head_plain(params, xh_p, oh_p)
                torch.cuda.synchronize()
                pairs = dict(zip(("xy", "aa", "bb", "pp", "dd"), zip(n_k, n_p)))
                pairs.update(y=(y_k, y_p), xs_h=(xh_k, xh_p), off_h=(oh_k, oh_p),
                             logits=(lg_k[:, :cfg_.vocab_size], lg_p[:, :cfg_.vocab_size]))
                for name, (x_k, x_p) in pairs.items():
                    require(bool(torch.isfinite(x_k).all()), f"{tag} B={B} step {step}: {name} "
                            "not finite")
                    err, serr = scaled_err(x_k, x_p)
                    require(serr <= DECODE_TOL, f"{tag} B={B} step {step}: {name} scaled error "
                            f"{serr:.3e} > {DECODE_TOL}")
                    worst[name] = max(worst.get(name, (0.0, 0.0)), (err, serr))
                st_k, st_p = n_k, n_p
            print(f"  {tag} B={B}, {steps} steps: max abs err (scaled <= {DECODE_TOL}): "
                  + ", ".join(f"{n} {e:.2e} ({s:.1e})" for n, (e, s) in worst.items()))
            rows[B] = dict(err=max(e for k, (e, _) in worst.items() if k != "logits"),
                           logits_err=worst["logits"][0])
            if not timed:
                continue
            tok = torch.from_numpy(rng.integers(0, cfg_.vocab_size, size=(B,))).to(dev)
            st = init_state(cfg_, (B,), device=dev)
            ds_ms = cuda_ms(lambda: ds_mod.decode_stack(params, tok, st), 20)
            step_ms = cuda_ms(lambda: ds_mod.forward_step_fused(params, tok, st), 20)
            ds_graph = graph_ms(lambda: ds_mod.decode_stack(params, tok, st), 20)
            step_graph = graph_ms(lambda: ds_mod.forward_step_fused(params, tok, st), 20)
            plain_ms = cuda_ms(lambda: ds_mod.decode_stack_plain(params, tok, st), 5, warmup=1)
            # + B embedding rows, state in and out, y and xs_h out
            ds_bytes = wb + vb + (B * E_ + 10 * L_ * B * E_ + 2 * B * E_ + B) * 4
            b_ms, b_by = bound(ds_bytes, 2 * B * L_ * 13 * E_ * E_)
            head = params.head
            head_bytes = nbytes([head.wp if isinstance(head, Quant4Linear) else head.w])
            step_bytes = wb + head_bytes
            rows[B].update(ms=ds_ms, step_ms=step_ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, graph_ms=ds_graph, step_graph_ms=step_graph)
            grid = ds_mod.stack_grid(B, E_, q4=isinstance(head, Quant4Linear))
            print(f"  {tag} B={B}: decode stack {ds_ms:.4f} ms/step ({ds_graph:.4f} replayed from a "
                  f"CUDA graph), with head {step_ms:.4f} ms ({step_graph:.4f} replayed), "
                  f"plain {plain_ms:.3f} ms; one launch of {grid} blocks, {4 * L_} grid "
                  f"barriers; stack bound {b_ms:.4f} ms ({b_by}, "
                  f"{(wb + vb) / 1e6:.1f} MB of weights and vectors); step bound "
                  f"{step_bytes / 1e6:.1f} MB: {step_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms at "
                  f"3.35 TB/s, {step_bytes / bw * 1e3:.4f} ms at the measured copy rate {card}")
        return rows

    print(f"phase 3 decode_stack (K1) + head (K2) vs plain, 430M: L={L} E={E} F={F}")
    t0 = time.perf_counter()
    host_u8 = random_quantized_params_np(cfg, seed=args.seed, pad_multiple=512)
    params = params_to(signedize_params(host_u8), dev)
    Vp = params.head.w.shape[1]
    print(f"  params ready in {time.perf_counter() - t0:.1f} s; layer weights "
          f"{weight_bytes(params) / 1e6:.1f} MB, head {E * Vp / 1e6:.1f} MB")
    ds_rows = check_decode(params, cfg, "q8", batches=(1, 8, 16))
    per_step = 1  # the decode stack is one cooperative launch a step
    del params

    # ------------------------------------------------------------------ 4
    print("phase 4 end to end: RWKV(path).load_context + generate, 430M .bin")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    bin_dir = tempfile.TemporaryDirectory(dir=_build.BUILD_DIR)  # phases 4 and 10
    bin_path = os.path.join(bin_dir.name, "rwkv4-430m-random.bin")
    t0 = time.perf_counter()
    write_bin(bin_path, host_u8)
    print(f"  wrote {os.path.getsize(bin_path) / 1e6:.0f} MB in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eng = RWKV(bin_path)
    eng.load_tokenizer()
    torch.cuda.synchronize()
    print(f"  RWKV(path) on {eng.device} + tokenizer in {time.perf_counter() - t0:.1f} s")
    require(eng.device.type == "cuda", f"engine runs on {eng.device}")
    signed = signedize_params(host_u8)
    require(np.array_equal(eng.params.att.key.w[3].cpu().numpy(), signed.att.key.w[3])
            and np.array_equal(eng.params.head.w[:, :cfg.vocab_size].cpu().numpy(),
                               signed.head.w[:, :cfg.vocab_size]),
            "weights read back from the .bin differ from the ones written")
    del signed, host_u8

    prompts = ["The quick brown fox jumps over the lazy dog. Once upon a time,",
               "In a hole in the ground there lived a hobbit.",
               "Question: what is the capital of France?\nAnswer:"]
    counters = (ds_mod, "launches"), (ds_mod, "launches_q4"), (mm8_mod, "launches"), \
        (mm4_mod, "launches"), (ds_mod, "launches_a8"), (mm8_mod, "launches_a8"), \
        (th, "launches_att"), (th, "launches_ffn"), (k7, "launches"), (k7, "launches_q4")
    COUNTER_NAMES = ("K1", "K4", "K2", "K3", "K5 stack", "K5 head", "K6 att", "K6 ffn", "K7",
                     "K7 q4")
    ms_per_token = {}  # decode ms/token graphed (and eager), by engine
    # (temp, tau, ban) of each prompt: they differ, so a value a capture baked
    # into a graph would show in the replays
    SETTINGS = [(0.9, 0.8, (0,)), (0.7, 0.5, (0, 11)), (1.2, 1.0, (0, 187, 13))]

    def answer(eng, max_tokens, chunk=1, show=False):
        """The prompts through load_context + generate, seeds seed + i;
        returns the texts."""
        texts = []
        for i, prompt in enumerate(prompts):
            eng.reset_state()
            n_prompt = len(eng.tokenizer.encode(prompt))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.load_context(prompt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            temp, tau, ban = SETTINGS[i]
            text = eng.generate("", max_tokens=max_tokens, temp=temp, tau=tau, seed=args.seed + i,
                                ban_tokens=ban, chunk=chunk)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            require(isinstance(text, str), "generate returned no text")
            texts.append(text)
            if show:
                print(f"  request {i}: prompt {n_prompt} tok, prefill {n_prompt / (t1 - t0):.1f} "
                      f"tok/s, decode {max_tokens / (t2 - t1):.1f} tok/s "
                      f"({(t2 - t1) / max_tokens * 1e3:.2f} ms/token, graphed, the first call "
                      f"of a chunk length capturing) {card}; text {text[:60]!r}")
        return texts

    def device_busy(fn) -> tuple[float, float]:
        """(wall ms, the device's busy share of it) of fn, by torch.profiler."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA) / 1e3
        return wall, busy / wall

    def serve(eng, max_tokens=32, label=None):
        """Answer the prompts with the decode graphed (runtime/graphs.py) and
        every launch count set to 0 just before; then the same requests
        eagerly, and graphed and eagerly at chunk 8: the same texts. Then
        decode ms/token and the device's busy share, graphed and eager in
        turns. Returns (decode steps, the counts just after the graphed run:
        K1, K4, K2, K3, K5's stack and head, K6's att and ffn halves, K7 q8
        and q4)."""
        g = eng._graphs
        require(g.enabled and eng.device.type == "cuda", "the engine's decode is not graphed")
        for mod, name in counters:
            setattr(mod, name, 0)
        texts = answer(eng, max_tokens, show=True)
        counts = tuple(getattr(mod, name) for mod, name in counters)
        steps = len(prompts) * (max_tokens - 1)
        replays = g.replays
        for chunk in (1, 8):
            for graphed in ((False,) if chunk == 1 else (True, False)):
                g.enabled = graphed
                require(answer(eng, max_tokens, chunk=chunk) == texts,
                        f"{label}: chunk {chunk} {'graphed' if graphed else 'eager'} texts differ "
                        "from the graphed chunk-1 run's")
        g.enabled = True
        n = 64

        def one(chunk=1, profiled=False):
            """ms/token of one request's generate (and the device's busy
            share of it, by torch.profiler, when profiled)."""
            eng.reset_state()
            eng.load_context(prompts[0])
            run = lambda: eng.generate("", max_tokens=n, temp=0.9, tau=0.8,  # noqa: E731
                                       seed=args.seed, chunk=chunk)
            if profiled:
                return device_busy(run)[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        one(8)  # capture chunk 8's graphs
        modes = [(True, 1), (False, 1), (True, 8), (False, 8)]
        turns = {m: [] for m in modes}
        for graphed, chunk in modes + modes[::-1]:  # in turns
            g.enabled = graphed
            turns[graphed, chunk].append(one(chunk))
        busy = {}
        for graphed in (True, False):
            g.enabled = graphed
            busy[graphed] = one(profiled=True)
        g.enabled = True
        fmt = lambda v: ", ".join(f"{x:.3f}" for x in v)  # noqa: E731
        print(f"  graphed texts equal the eager ones, at chunk 1 and 8 ({len(g)} graphs: the "
              f"first id, k = 1, 8 and 7; {g.replays - replays} replays since the first run); "
              f"decode ms/token over {n} tokens, in turns: " + "; ".join(
                  f"{'graphed' if gr else 'eager'} chunk {c} {fmt(v)}"
                  for (gr, c), v in turns.items())
              + f"; device busy at chunk 1 (torch.profiler over generate) graphed "
              f"{busy[True]:.1%}, eager {busy[False]:.1%} {card}")
        if label:
            ms_per_token[label] = (min(turns[True, 1]), min(turns[False, 1]), busy[True],
                                   busy[False], min(turns[True, 8]), min(turns[False, 8]))
        return steps, counts

    def a8_step_plain(params, tok, state, block):
        """The plain W8A8 step: the a8 stack and the a8 head."""
        _, new, xh, oh = ds_mod.decode_stack_plain(params, tok.reshape(-1), WKVState(
            *(s.reshape(s.shape[0], -1, s.shape[-1]) for s in state)), a8=True, a8_block=block)
        return mm8_mod.mm8_a8_plain(xh, params.head.w, row_add=oh,
                                    col_add=params.logit_bias), new

    def check_engine_logits(eng, vocab, a8_block=None, ref_params=None):
        """The engine's decode step on the loaded weights against the plain
        model (a8_block: against the plain W8A8 step; ref_params: the
        weights the plain model runs, default the engine's)."""
        eng.reset_state()
        eng.load_context(prompts[0])
        state = eng.get_state(0)
        tok = int(eng.tokenizer.encode(" It")[0])
        logits = eng.forward(tok)
        tok_d = torch.tensor(tok, device=dev)
        if a8_block is None:
            ref, _ = forward_step(eng.params if ref_params is None else ref_params, tok_d, state)
            tol = DECODE_TOL
        else:
            ref = a8_step_plain(eng.params, tok_d, state, a8_block)[0][0]
            tol = A8_DECODE_TOL
        torch.cuda.synchronize()
        require(logits.shape == (vocab,), f"logits shape {tuple(logits.shape)}")
        require(bool(torch.isfinite(logits).all()), "engine logits not finite")
        err, serr = scaled_err(logits, ref[:vocab])
        require(serr <= tol, f"engine logits vs plain: scaled error {serr:.3e}")
        require(int(logits.argmax()) == int(ref[:vocab].argmax()), "engine argmax differs")
        print(f"  engine decode logits vs plain {'a8 step' if a8_block else 'forward_step'}: "
              f"max abs err {err:.2e} (scaled {serr:.1e} <= {tol}), argmax "
              f"{int(logits.argmax())} == {int(ref[:vocab].argmax())}")

    steps, (k1_launches, k4_seen, k2_launches, k3_seen, *_) = serve(eng, label="K1")
    print(f"  launches during the requests: decode_stack q8 {k1_launches} "
          f"(= {per_step} per step x {steps} steps: {k1_launches == per_step * steps}), "
          f"mm8 {k2_launches}; q4 kernels {k4_seen}, {k3_seen}")
    require(k1_launches > 0, "decode_stack kernel never launched on the main path")
    require(k1_launches == per_step * steps, f"decode_stack: {k1_launches} launches for {steps} "
            "decoded steps, not one each")
    require(k2_launches > 0, "mm8 kernel never launched on the main path")
    require(k4_seen == 0 and k3_seen == 0, "the q8 path launched a q4 kernel")
    check_engine_logits(eng, cfg.vocab_size)
    print(f"  the engine holds {len(eng._graphs)} graphs (the first id; k = 1, 8 and 7); "
          f"the shared graph pool {graphs_mod.memory_pool_bytes() / 2**20:.1f} MiB")
    del eng
    for B in (1, 8):  # the sampler alone: the engine's [V] row, the pool's [8, V]
        shape = (B, Vp) if B > 1 else (Vp,)
        lg = torch.randn(shape, device=dev) * 3
        gens = [torch.Generator(device=dev) for _ in range(B)]
        for i, g in enumerate(gens):
            g.manual_seed(args.seed + i)
        temp_t = torch.full(shape[:-1], 0.9, dtype=torch.float64, device=dev)
        tau_t = torch.full(shape[:-1], 0.8, device=dev)
        draw = lambda: typical(lg, gens if B > 1 else gens[0], temp_t, tau_t)  # noqa: E731,B023
        t_ms = graph_ms(draw, 20, generators=gens)
        f_ms = graph_ms(lambda: typical(lg, gens if B > 1 else gens[0], 0.9, 0.8),  # noqa: B023
                        20, generators=gens)
        e_ms = cuda_ms(draw, 20)
        b_ms, b_by = bound(B * Vp * 4 + B * 8, 0)
        print(f"  typical over [{B}, {Vp}] logits: {t_ms:.4f} ms on the device with tensor "
              f"settings (replayed from a CUDA graph, 20 calls; {f_ms:.4f} with float "
              f"settings), {e_ms:.4f} ms called back to back from Python; the logits read "
              f"once {b_ms:.4f} ms ({b_by}) {card}")

    # ------------------------------------------------------------------ 5
    print("phase 5 mm4 (K3) vs plain, [B, 1024] x packed [512, 50688] int8")
    copies = [torch.from_numpy(rng.integers(-128, 128, size=(K // 2, O), dtype=np.int8)).to(dev)
              for _ in range(6)]
    wp = copies[0]
    w_f32 = unpack4(wp).float()  # the yardstick's operand, prepared beforehand
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mm4_rows = {}
    for B in (1, 8, 16):
        xs = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32) / 1000).to(dev)
        got = mm4_mod.mm4(xs, wp)
        again = mm4_mod.mm4(xs, wp)
        ref = mm4_mod.mm4_plain(xs, wp)
        torch.cuda.synchronize()
        err, serr = scaled_err(got, ref)
        require(bool(torch.isfinite(got).all()), f"mm4 B={B}: non-finite output")
        require(serr <= MM4_TOL, f"mm4 B={B}: scaled error {serr:.3e} > {MM4_TOL}")
        require(torch.equal(again, got), f"mm4 B={B}: two calls gave different bits")
        eager_ms = cuda_ms(lambda: mm4_mod.mm4(xs, wp), 50)
        ms = graph_median_ms(lambda: mm4_mod.mm4(xs, wp), 50, 15)
        cold_ms = cold_median_ms(lambda w: mm4_mod.mm4(xs, w), copies, 48, 15)
        plain_ms = cuda_ms(lambda: mm4_mod.mm4_plain(xs, wp), 20)
        lib_ms = cuda_ms(lambda: torch.matmul(xs, w_f32), 50)
        plan = mm4_mod.plan(B, K, O, sms)
        N = 8 * plan["nt"]  # three bf16 pieces a row, rounded up to 8 columns
        b_ms, b_by = bound(K * O // 2 + B * K * 4 + B * O * 4, 2 * O * K * N, PEAK_BF16_FLOPS)
        mm4_rows[B] = dict(err=err, ms=cold_ms, warm_ms=ms, eager_ms=eager_ms,
                           plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"  B={B}: max abs err {err:.3e} (scaled {serr:.3e} <= {MM4_TOL}), the same bits "
              f"twice; cut {plan}; kernel from HBM {cold_ms:.4f} ms (graph-replay median, 6 "
              f"copies), warm {ms:.4f} (one weight, L2-resident), eager {eager_ms:.4f}; plain "
              f"{plain_ms:.4f} ms, torch.matmul on widened W {lib_ms:.4f} ms; bound {b_ms:.4f} "
              f"ms ({b_by}, published peaks; products at N={N} on bf16 tensor cores) = "
              f"{b_ms / cold_ms:.0%} of the HBM time; {K * O / 2 / bw * 1e3:.4f} ms at the "
              f"measured copy rate; {K * O / 2 / (cold_ms * 1e-3) / 1e9:.0f} GB/s of packed "
              f"weights from HBM {card}")
    print(f"  B=16 against B=1 from HBM: {mm4_rows[16]['ms'] / mm4_rows[1]['ms']:.2f}x "
          f"(each weight byte read once for all 16 rows)")
    del wp, w_f32, copies

    # ------------------------------------------------------------------ 6
    print(f"phase 6 decode_stack q4 (K4) + head (K3) vs plain, 430M: L={L} E={E} F={F}")
    t0 = time.perf_counter()
    host_q4 = random_quantized_params_np(cfg, seed=args.seed + 1, pad_multiple=512, q4=True)
    params = params_to(host_q4, dev)
    print(f"  params ready in {time.perf_counter() - t0:.1f} s; packed layer weights "
          f"{weight_bytes(params) / 1e6:.1f} MB, head {params.head.wp.numel() / 1e6:.1f} MB; "
          f"blocks att.output {params.att.output.block}, ffn.value {params.ffn.value.block}")
    q4_rows = check_decode(params, cfg, "q4", batches=(1, 8, 16))
    del params
    cfg7 = RWKVConfig(n_layer=2, n_embd=4096)
    t0 = time.perf_counter()
    params = params_to(random_quantized_params_np(cfg7, seed=args.seed + 2, pad_multiple=512,
                                                  q4=True), dev)
    print(f"  7B widths, L=2 (E=4096, F=16384): params ready in {time.perf_counter() - t0:.1f} "
          f"s; blocks att.output {params.att.output.block}, ffn.value "
          f"{params.ffn.value.block}; {weight_bytes(params) / 1e6:.1f} MB of layers")
    require(params.att.output.block < cfg7.n_embd and params.ffn.value.block < cfg7.n_ffn,
            "the 7B check must pair within sub-K blocks")
    check_decode(params, cfg7, "q4 7B", steps=2, timed=False)
    del params

    # ------------------------------------------------------------------ 7
    print("phase 7 end to end: RWKV(path) on a 430M q4 artifact, and on a dense checkpoint")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "rwkv4-430m-random.q4.safetensors")
        t0 = time.perf_counter()
        save_q4(path, host_q4)
        print(f"  wrote {os.path.getsize(path) / 1e6:.0f} MB in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        eng = RWKV(path)
        eng.load_tokenizer()
        torch.cuda.synchronize()
        print(f"  RWKV(path) on {eng.device} + tokenizer in {time.perf_counter() - t0:.1f} s")
    require(eng.device.type == "cuda" and eng.quant == "q4",
            f"engine runs {eng.quant} on {eng.device}")
    require(np.array_equal(eng.params.att.key.wp[3].cpu().numpy(), host_q4.att.key.wp[3])
            and np.array_equal(eng.params.head.wp.cpu().numpy(), host_q4.head.wp),
            "weights read back from the artifact differ from the ones written")
    del host_q4
    steps4, (k1_seen, k4_launches, k2_seen, k3_launches, *_) = serve(eng, label="K4")
    print(f"  launches during the requests: decode_stack q4 {k4_launches} "
          f"(= {per_step} per step x {steps4} steps: {k4_launches == per_step * steps4}), "
          f"mm4 {k3_launches}; q8 kernels {k1_seen}, {k2_seen}")
    require(k4_launches > 0, "the q4 decode_stack kernel never launched on the q4 path")
    require(k4_launches == per_step * steps4, f"decode_stack q4: {k4_launches} launches for "
            f"{steps4} decoded steps, not one each")
    require(k3_launches > 0, "mm4 kernel never launched on the q4 path")
    require(k1_seen == 0 and k2_seen == 0, "the q4 path launched a q8 kernel")
    check_engine_logits(eng, cfg.vocab_size)
    del eng

    # a dense f32 checkpoint at 430M width, L=2, BlinkDL names, quantized at load
    drng = np.random.default_rng(args.seed + 3)
    E2, V2 = cfg.n_embd, cfg.vocab_size

    def r(*shape, scale):
        return drng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    dense = {"emb.weight": r(V2, E2, scale=0.1), "head.weight": r(V2, E2, scale=E2 ** -0.5),
             "ln_out.weight": np.ones(E2, np.float32), "ln_out.bias": np.zeros(E2, np.float32),
             "blocks.0.ln0.weight": np.ones(E2, np.float32),
             "blocks.0.ln0.bias": np.zeros(E2, np.float32)}
    for i in range(2):
        b = f"blocks.{i}."
        for n in ("ln1", "ln2"):
            dense[b + n + ".weight"] = np.ones(E2, np.float32)
            dense[b + n + ".bias"] = np.zeros(E2, np.float32)
        for m in ("k", "v", "r"):
            dense[b + f"att.time_mix_{m}"] = drng.random((1, 1, E2), dtype=np.float32)
        for m in ("k", "r"):
            dense[b + f"ffn.time_mix_{m}"] = drng.random((1, 1, E2), dtype=np.float32)
        dense[b + "att.time_decay"] = r(E2, scale=1.0)
        dense[b + "att.time_first"] = r(E2, scale=0.5)
        for m in ("key", "value", "receptance", "output"):
            dense[b + f"att.{m}.weight"] = r(E2, E2, scale=E2 ** -0.5)
        dense[b + "ffn.key.weight"] = r(4 * E2, E2, scale=E2 ** -0.5)
        dense[b + "ffn.value.weight"] = r(E2, 4 * E2, scale=(4 * E2) ** -0.5)
        dense[b + "ffn.receptance.weight"] = r(E2, E2, scale=E2 ** -0.5)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "rwkv4-430m-width-l2-dense.safetensors")
        write_safetensors(path, dense)
        del dense
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        eng = RWKV(path, quant="q4")
        eng.load_tokenizer()
        torch.cuda.synchronize()
        print(f"  RWKV(path, quant='q4') on a {size / 1e6:.0f} MB dense f32 .safetensors "
              f"(L=2, E={E2}): quantized and loaded in {time.perf_counter() - t0:.1f} s; "
              f"blocks att.output {eng.params.att.output.block}, ffn.value "
              f"{eng.params.ffn.value.block}")
    require(eng.quant == "q4" and isinstance(eng.params.att.key, Quant4Linear),
            "the dense checkpoint did not load as q4")
    for mod, name in counters:
        setattr(mod, name, 0)
    eng.load_context(prompts[1])
    text = eng.generate("", max_tokens=8, temp=0.9, tau=0.8, seed=args.seed)
    torch.cuda.synchronize()
    dense_counts = (ds_mod.launches_q4, mm4_mod.launches)
    print(f"  decoded 8 tokens: {text!r}; launches decode_stack q4 {dense_counts[0]}, "
          f"mm4 {dense_counts[1]}")
    require(dense_counts[0] > 0 and dense_counts[1] > 0,
            "the dense q4 route did not run the q4 kernels")
    check_engine_logits(eng, cfg.vocab_size)
    del eng

    # ------------------------------------------------------------------ 8
    print("phase 8 mm8_a8 (K5, head) vs plain, [B, 1024] x [1024, 50688] int8")
    w = torch.from_numpy(rng.integers(-128, 128, size=(K, O), dtype=np.int8)).to(dev)
    a8_rows = {}
    for B in (1, 8, 16):
        xs = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32) / 1000).to(dev)
        got, codes, scale = mm8_mod.mm8_a8(xs, w, return_codes=True)
        ref = mm8_mod.mm8_a8_plain(xs, w)
        q_ref, s_ref = mm8_mod.quant_rows(xs)
        torch.cuda.synchronize()
        require(torch.equal(codes, q_ref) and torch.equal(scale, s_ref),
                f"mm8_a8 B={B}: the kernel's int8 codes or scales differ from quant_rows")
        err, serr = scaled_err(got, ref)
        require(bool(torch.isfinite(got).all()), f"mm8_a8 B={B}: non-finite output")
        require(serr <= MM8_A8_TOL, f"mm8_a8 B={B}: scaled error {serr:.3e} > {MM8_A8_TOL}")
        eager_ms = cuda_ms(lambda: mm8_mod.mm8_a8(xs, w), 50)
        ms = graph_median_ms(lambda: mm8_mod.mm8_a8(xs, w), 50, 15)
        plain_ms = cuda_ms(lambda: mm8_mod.mm8_a8_plain(xs, w), 5, warmup=1)
        codes24 = torch.zeros((24, K), dtype=torch.int8, device=dev)  # _int_mm takes > 16 rows
        codes24[:B] = codes
        lib_ms = cuda_ms(lambda: torch._int_mm(codes24, w), 50)
        b_ms, b_by = bound(K * O + B * K * 4 + B * O * 4, 2 * B * K * O, PEAK_INT8_OPS)
        a8_rows[B] = dict(err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, lib_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by)
        print(f"  B={B}: codes equal; max abs err {err:.3e} (scaled {serr:.3e} <= {MM8_A8_TOL}); "
              f"kernel {ms:.4f} ms (graph-replay median; {eager_ms:.4f} eager), plain "
              f"{plain_ms:.4f} ms, torch._int_mm on the codes (24 rows) "
              f"{lib_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, published peaks); "
              f"{K * O / (ms * 1e-3) / 1e9:.0f} GB/s of weights {card}")
    del w, codes24

    # ------------------------------------------------------------------ 9
    blk = a8_block_for(E)
    print(f"phase 9 decode_stack a8 (K5, stack) + a8 head vs plain a8, 430M: L={L} E={E} F={F}, "
          f"a8_block {blk}")
    params = params_to(signedize_params(random_quantized_params_np(
        cfg, seed=args.seed + 4, pad_multiple=512)), dev)
    wb, vb = weight_bytes(params), vector_bytes(params)
    head_bytes = nbytes([params.head.w])
    a8_stack_rows = {}
    for B in (1, 8, 16):
        st_k = st_p = init_state(cfg, (B,), device=dev)
        worst = {}
        for step in range(4):
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
            before = (ds_mod.launches, ds_mod.launches_a8, mm8_mod.launches_a8)
            lg_k, n_k = ds_mod.forward_step_fused(params, tok, st_k, a8=True, a8_block=blk)
            after = (ds_mod.launches, ds_mod.launches_a8, mm8_mod.launches_a8)
            require([a - b for a, b in zip(after, before)] == [0, per_step, 1],
                    f"a8 B={B}: launches {after} after {before}")
            lg_p, n_p = a8_step_plain(params, tok, st_p, blk)
            torch.cuda.synchronize()
            pairs = dict(zip(("xy", "aa", "bb", "pp", "dd"), zip(n_k, n_p)))
            pairs["logits"] = (lg_k[:, :cfg.vocab_size], lg_p[:, :cfg.vocab_size])
            for name, (x_k, x_p) in pairs.items():
                require(bool(torch.isfinite(x_k).all()), f"a8 B={B} step {step}: {name} not finite")
                err, serr = scaled_err(x_k, x_p)
                require(serr <= A8_DECODE_TOL, f"a8 B={B} step {step}: {name} scaled error "
                        f"{serr:.3e} > {A8_DECODE_TOL}")
                worst[name] = max(worst.get(name, (0.0, 0.0)), (err, serr))
                require(name == "logits" or torch.equal(x_k, x_p),
                        f"a8 B={B} step {step}: state {name} differs from the plain a8 step's bits")
            require(torch.equal(pairs["logits"][0].argmax(-1), pairs["logits"][1].argmax(-1)),
                    f"a8 B={B} step {step}: argmax differs from the plain a8 step")
            st_k, st_p = n_k, n_p
        print(f"  a8 B={B}, 4 steps: state bit-equal; max abs err (scaled <= {A8_DECODE_TOL}), "
              "argmax equal: "
              + ", ".join(f"{n} {e:.2e} ({s:.1e})" for n, (e, s) in worst.items()))
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        st = init_state(cfg, (B,), device=dev)
        a8_step = lambda: ds_mod.forward_step_fused(params, tok, st, a8=True, a8_block=blk)  # noqa: E731,B023
        q8_step = lambda: ds_mod.forward_step_fused(params, tok, st)  # noqa: E731,B023
        t = {"q8": [], "a8": []}
        for name in ("q8", "a8", "a8", "q8"):  # in turns
            t[name].append(cuda_ms(a8_step if name == "a8" else q8_step, 20))
        ds_ms = cuda_ms(lambda: ds_mod.decode_stack(params, tok, st, a8=True, a8_block=blk), 20)
        ds_graph = graph_ms(lambda: ds_mod.decode_stack(params, tok, st, a8=True, a8_block=blk), 20)
        plain_ms = cuda_ms(lambda: ds_mod.decode_stack_plain(params, tok, st, a8=True,
                                                             a8_block=blk), 3, warmup=1)
        ds_bytes = wb + vb + (B * E + 10 * L * B * E + 2 * B * E + B) * 4
        b_ms, b_by = bound(ds_bytes, 2 * B * L * 13 * E * E, PEAK_INT8_OPS)
        a8_stack_rows[B] = dict(err=max(e for k, (e, _) in worst.items() if k != "logits"),
                                ms=ds_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                graph_ms=ds_graph)
        print(f"  B={B}: a8 step {min(t['a8']):.3f} ms ({', '.join(f'{v:.3f}' for v in t['a8'])}), "
              f"q8 step {min(t['q8']):.3f} ms ({', '.join(f'{v:.3f}' for v in t['q8'])}), in "
              f"turns; {per_step} + 1 launches per step each; a8 stack alone {ds_ms:.4f} ms "
              f"({ds_graph:.4f} replayed from a CUDA graph), "
              f"plain a8 stack {plain_ms:.3f} ms; stack bound {b_ms:.4f} ms ({b_by}), step bound "
              f"{(wb + head_bytes) / PEAK_BYTES_PER_S * 1e3:.4f} ms {card}")
    del params

    # ------------------------------------------------------------------ 10
    print("phase 10 serving: RWKV(path) a8 + InferencePool(max_streams=8), 12 requests")
    eng = RWKV(bin_path)
    eng.load_tokenizer()
    eng.load_params(eng.params, a8=True)
    require(eng._step_fn.keywords == {"a8": True, "a8_block": blk}, "the engine's step is not a8")
    check_engine_logits(eng, cfg.vocab_size, a8_block=blk)
    story = " ".join(prompts) * 40
    ids = eng.tokenizer.encode(story)
    spec = [(5, 16), (300, 24), (40, 64), (130, 32), (12, 48), (260, 16), (77, 40), (200, 64),
            (9, 32), (150, 24), (33, 64), (128, 40)]  # (prompt tokens, max_tokens)
    reqs = [dict(prompt=eng.tokenizer.decode(ids[i * 7:i * 7 + n]), max_tokens=m,
                 temp=(0.7, 0.9, 1.0, 1.2)[i % 4], tau=(0.5, 0.8, 1.0)[i % 3], seed=args.seed + i,
                 stop=["\n\n", "."] if i % 4 == 1 else None)
            for i, (n, m) in enumerate(spec)]

    def run_pool(step_fn, reqs, slots=8, graphed=True, step_chunk=1):
        """Serve `reqs` through a fresh pool, its decode program graphed or
        eager: the first `slots` at once, the rest one at a time as slots
        free up (each then admitted alone). Returns (texts, generated
        tokens, wall s, ms per step at full occupancy)."""
        pool = InferencePool(eng.params, eng.tokenizer, max_streams=slots, prefill_bucket=128,
                             step_fn=step_fn, step_chunk=step_chunk)
        pool._graphs.enabled = graphed
        todo = list(reqs)
        rids, texts, full_ms, made = [], {}, [], 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while todo and len(rids) < slots:
            rids.append(pool.submit(**todo.pop(0)))
        while todo or pool.pending:
            if todo and pool._free and not pool._queue:
                rids.append(pool.submit(**todo.pop(0)))
            full = len(pool._by_slot) == slots
            ts = time.perf_counter()
            done = pool.step()
            if full:
                full_ms.append((time.perf_counter() - ts) * 1e3)
            for r in done:
                texts[r.rid] = r.text
                made += r.produced
        wall = time.perf_counter() - t0
        require(len(pool._graphs) == (1 if graphed else 0),
                f"the pool made {len(pool._graphs)} graphs")
        return [texts[r] for r in rids], made, wall, full_ms

    for mod, name in counters:
        setattr(mod, name, 0)
    texts, made, wall, full_ms = run_pool(eng._step_fn, reqs)
    counts = dict(zip(("K1", "K4", "K2", "K3", "K5 stack", "K5 head"),
                      (getattr(mod, name) for mod, name in counters)))
    require(len(texts) == 12 and all(isinstance(t, str) for t in texts),
            "not every request finished")
    require(counts["K5 stack"] > 0 and counts["K5 head"] > 0, f"K5 never launched: {counts}")
    require(counts["K1"] == 0 and counts["K2"] == 0 and counts["K4"] == 0 and counts["K3"] == 0,
            f"the a8 pool launched a q8 or q4 kernel: {counts}")
    k5_stack_launches, k5_head_launches = counts["K5 stack"], counts["K5 head"]
    full_a8 = sorted(full_ms)[len(full_ms) // 2]
    print(f"  a8: 12 requests, {made} tokens generated in {wall:.2f} s: {made / wall:.1f} tok/s; "
          f"{len(full_ms)} steps at full occupancy, median {full_a8:.3f} ms/step {card}; "
          f"launches {counts}")
    for i in (1, 5, 11):
        print(f"  request {i}: {spec[i][0]} prompt tokens, max {spec[i]} -> {texts[i][:50]!r}")
    alone, _, _, _ = run_pool(eng._step_fn, [reqs[11]])
    require(alone[0] == texts[11], "request 11 alone gives another text than among batchmates")
    print("  request 11 re-run alone in a fresh 8-slot pool: the same text")
    eager_texts, _, _, _ = run_pool(eng._step_fn, reqs, graphed=False)
    require(eager_texts == texts, "the graphed pool's texts differ from the eager pool's")
    for k in (4,):
        for graphed in (True, False):
            got, _, _, _ = run_pool(eng._step_fn, reqs, graphed=graphed, step_chunk=k)
            require(got == texts, f"step_chunk {k} {'graphed' if graphed else 'eager'} texts "
                    "differ from step_chunk 1's")
    print("  the 12 texts equal an eager pool's, and at step_chunk 4 graphed and eager")
    steps_a8 = partial(ds_mod.forward_step_fused, a8=True, a8_block=blk)
    serve(eng, label="K5")

    eng.load_params(eng.params)  # the q8 step, K1 + K2
    check_engine_logits(eng, cfg.vocab_size)
    for mod, name in counters:
        setattr(mod, name, 0)
    short_reqs = [dict(r, max_tokens=32) for r in reqs[:8]]
    steps = {"q8": eng._step_fn, "a8": steps_a8}
    runs = {(n, g): [] for n in ("q8", "a8") for g in (True, False)}
    order = [("q8", True), ("a8", True), ("a8", False), ("q8", False)]
    for name, graphed in order + order[::-1]:  # in turns
        _, made_r, wall_r, full_r = run_pool(steps[name], short_reqs, graphed=graphed)
        if name == "q8" and not runs["q8", True]:  # the first q8 run: K1 + K2 only
            counts_q8 = dict(zip(("K1", "K4", "K2", "K3", "K5 stack", "K5 head"),
                                 (getattr(mod, n) for mod, n in counters)))
            require(counts_q8["K1"] > 0 and counts_q8["K2"] > 0 and counts_q8["K5 stack"] == 0
                    and counts_q8["K5 head"] == 0, f"the q8 pool's launches: {counts_q8}")
        runs[name, graphed].append((made_r / wall_r, sorted(full_r)[len(full_r) // 2]))
    print("  the first 8 requests at 32 tokens, in turns (q8 and a8, graphed and eager): "
          + "; ".join(f"{n} {'graphed' if g else 'eager'} " + ", ".join(
              f"{tps:.1f} tok/s (median {ms:.3f} ms/step at full occupancy)" for tps, ms in v)
              for (n, g), v in runs.items()) + f" {card}")
    del eng

    # ------------------------------------------------------------------ 11
    def check_halves(params, cfg_, tps, batches, tag):
        """K6 against its plain versions for every shard of each tp, every
        layer, each B; the shards' partials summed against the tp = 1 call
        (tps[0] must be 1). Returns the worst absolute errors of att_half
        and ffn_half at tp = 1, B = batches[0]."""
        E_ = cfg_.n_embd
        sharded = {tp: shard_params(params, make_mesh(model=tp, devices=[dev] * tp))
                   for tp in tps}
        worst, first = {}, {}
        for B in batches:
            for l in range(cfg_.n_layer):
                x, xy, dd, aa, pp = (torch.randn((B, E_), device=dev) for _ in range(5))
                bb = torch.randn((B, E_), device=dev).abs() + 0.5
                ref = None
                for tp in tps:
                    sp, El = sharded[tp], E_ // tp
                    parts, vparts, gates = [], [], []
                    for j in range(tp):
                        p = sp.rows[0][j]
                        cut = [t[:, j * El:(j + 1) * El].contiguous() for t in (aa, bb, pp)]
                        got = th.att_half(p, l, x, xy, *cut, *sp.local(0, j))
                        got_f = th.ffn_half(p, l, x, dd)
                        want = th.att_half_plain(p, l, x, xy, *cut, *sp.local(0, j))
                        want_f = th.ffn_half_plain(p, l, x, dd)
                        torch.cuda.synchronize()
                        names = ("partial", "aa", "bb", "pp", "xy", "vpartial", "gate", "dd")
                        for name, a, b in zip(names, got + got_f, want + want_f):
                            require(bool(torch.isfinite(a).all()),
                                    f"K6 {tag} tp={tp} B={B} layer {l} shard {j}: {name} not finite")
                            err, serr = scaled_err(a, b)
                            require(serr <= K6_TOL, f"K6 {tag} tp={tp} B={B} layer {l} shard {j}: "
                                    f"{name} scaled error {serr:.3e} > {K6_TOL}")
                            worst[tp, name] = max(worst.get((tp, name), (0.0, 0.0)), (err, serr))
                            if tp == 1 and B == batches[0]:
                                half = "att" if name in names[:5] else "ffn"
                                first[half] = max(first.get(half, 0.0), err)
                        parts.append(got[0])
                        vparts.append(got_f[0])
                        gates.append(got_f[1])
                    if ref is None:
                        ref = (parts[0], vparts[0], gates[0])
                        continue
                    total, vtotal = parts[0], vparts[0]
                    for a, b in zip(parts[1:], vparts[1:]):  # the fixed order 0..tp-1
                        total, vtotal = total + a, vtotal + b
                    for name, a, b in (("partial", total, ref[0]), ("vpartial", vtotal, ref[1]),
                                       ("gate", torch.cat(gates, dim=1), ref[2])):
                        err, serr = scaled_err(a, b)
                        require(serr <= K6_SUM_TOL, f"K6 {tag} tp={tp} B={B} layer {l}: summed "
                                f"{name} vs tp=1 scaled error {serr:.3e} > {K6_SUM_TOL}")
                        worst[tp, "sum " + name] = max(worst.get((tp, "sum " + name), (0.0, 0.0)),
                                                       (err, serr))
        for tp in tps:
            print(f"  {tag} tp={tp} (E/tp={E_ // tp}, F/tp={cfg_.n_ffn // tp}), B in {batches}, "
                  f"{cfg_.n_layer} layers: max abs err (scaled) "
                  + ", ".join(f"{n} {e:.2e} ({r:.1e})" for (t, n), (e, r) in worst.items()
                              if t == tp))
        del sharded
        return first

    print(f"phase 11 tp_halves (K6) vs plain, 430M shard widths: L={L} E={E} F={F}, tp 1, 2, 4 "
          "on a virtual mesh")
    params = params_to(signedize_params(random_quantized_params_np(
        cfg, seed=args.seed + 5, pad_multiple=512)), dev)
    torch.manual_seed(args.seed)  # check_halves' inputs
    k6_err = check_halves(params, cfg, (1, 2, 4), (1, 8), "430M")
    for B in (1, 8):  # how the four launches are cut; one wave at 430M, tp = 1
        for tp in (1, 2, 4):
            pl = th.plan(B, E, E // tp, F // tp)
            print(f"  plan B={B} tp={tp}: " + "; ".join(
                f"{n} {r['blocks'] // r['cluster']} clusters of {r['cluster']} "
                f"({r['smem_bytes'] / 1024:.1f} KiB, {r['pass_rows']} rows a block, "
                f"{r['active_clusters']} clusters co-resident)" for n, r in pl.items()))
            if tp == 1:
                require(all(r["blocks"] <= r["cluster"] * r["active_clusters"]
                            for r in pl.values()), f"K6 at 430M tp=1 B={B}: a launch takes "
                        f"more than one wave: {pl}")
    x, xy, dd, aa, pp = (torch.randn((8, E), device=dev) for _ in range(5))
    bb = torch.randn((8, E), device=dev).abs() + 0.5
    dl, bl = params.att.decay, params.att.bonus
    both = lambda: (th.att_half(params, 3, x, xy, aa, bb, pp, dl, bl)  # noqa: E731
                    + th.ffn_half(params, 3, x, dd))
    eager_out, again = both(), both()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = both()
    same = all(torch.equal(a, b) for a, b in zip(eager_out, again))
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(a, b) for a, b in zip(captured, eager_out))
    require(same, "K6: two calls or graph replays of one input gave different bits")
    del g, captured
    print("  B=8, layer 3: the same bits on two calls and from 3 CUDA-graph replays")
    El_bytes = lambda B, E_, El: 4 * E_ * El + (11 * E_ + 4 * El) * 4 + (4 * B * E_ + 6 * B * El) * 4  # noqa: E731,E501
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    k6_rows = {}
    for B in (1, 8):
        x, xy, dd = (torch.randn((B, E), device=dev) for _ in range(3))
        aa, pp = torch.randn((B, E), device=dev), torch.randn((B, E), device=dev)
        bb = torch.randn((B, E), device=dev).abs() + 0.5
        att = lambda: th.att_half(params, 0, x, xy, aa, bb, pp, dl, bl)  # noqa: E731,B023
        ffn = lambda: th.ffn_half(params, 0, x, dd)  # noqa: E731,B023
        att_eager, ffn_eager = cuda_ms(att, 50), cuda_ms(ffn, 50)
        t = time_halves(params, B, 15, gen)
        att_plain = cuda_ms(lambda: th.att_half_plain(params, 0, x, xy, aa, bb, pp, dl, bl), 20)  # noqa: B023,E501
        ffn_plain = cuda_ms(lambda: th.ffn_half_plain(params, 0, x, dd), 20)  # noqa: B023
        att_b = bound(El_bytes(B, E, E), 2 * B * 4 * E * E)
        # ffn: weights 2 E F + E E, vectors (ln2, mixes, key and receptance
        # scale/offset: 8 E; value scale/offset: 2 F), x, dd in; partial, gate, dd out
        ffn_b = bound(2 * E * F + E * E + (8 * E + 2 * F) * 4 + (5 * B * E) * 4,
                      2 * B * (2 * E * F + E * E))
        k6_rows[B] = dict(att_ms=t["att_ms_per_layer"], ffn_ms=t["ffn_ms_per_layer"],
                          att_hot=t["att_ms_one_layer_l2_hot"], ffn_hot=t["ffn_ms_one_layer_l2_hot"],
                          att_plain=att_plain, ffn_plain=ffn_plain, att_bound=att_b,
                          ffn_bound=ffn_b)
        r = k6_rows[B]
        share = ds_rows[1]["ms"] / L if B == 1 else ds_rows[8]["ms"] / L
        print(f"  tp=1 B={B}: per layer over all {L} layers from a CUDA graph (weights from "
              f"device memory; median of 15 replays): att_half {r['att_ms']:.4f} ms, ffn_half "
              f"{r['ffn_ms']:.4f} ms (2 launches each), together {r['att_ms'] + r['ffn_ms']:.4f} "
              f"ms per layer against K1's per-layer share {share:.4f} ms (phase 3 step / L); "
              f"layer 0 repeated, L2-hot: {r['att_hot']:.4f} + {r['ffn_hot']:.4f} ms; called back "
              f"to back from Python {att_eager:.4f} + {ffn_eager:.4f} ms; plain "
              f"{att_plain:.4f} + {ffn_plain:.4f} ms; bounds {att_b[0]:.4f} ms ({att_b[1]}) + "
              f"{ffn_b[0]:.4f} ms ({ffn_b[1]}) {card}")
    del params
    cfg14 = RWKVConfig(n_layer=2, n_embd=5120, vocab_size=512)
    t0 = time.perf_counter()
    params = params_to(signedize_params(random_quantized_params_np(
        cfg14, seed=args.seed + 6, pad_multiple=512)), dev)
    print(f"  14B widths, L=2 (E=5120, F=20480): params ready in {time.perf_counter() - t0:.1f} s;"
          f" {weight_bytes(params) / 1e6:.1f} MB of layers")
    check_halves(params, cfg14, (1, 8), (1, 8), "14B")
    del params

    # ------------------------------------------------------------------ 12
    print("phase 12 tensor-parallel serving: RWKV(path, sharding=make_mesh(model=1)), 430M .bin")
    t0 = time.perf_counter()
    eng = RWKV(bin_path, sharding=make_mesh(model=1), tp_body="halves")
    eng.load_tokenizer()
    torch.cuda.synchronize()
    print(f"  RWKV(path, sharding=make_mesh(model=1), tp_body='halves') on {eng.device} in "
          f"{time.perf_counter() - t0:.1f} s; step body {eng._step_fn.body}")
    require(eng.device.type == "cuda" and eng._step_fn.body == "halves" and eng._step_fn.graphed,
            f"the tp=1 engine runs body {eng._step_fn.body} on {eng.device}, graphed "
            f"{getattr(eng._step_fn, 'graphed', None)}")
    steps12, counts12 = serve(eng, label="tp=1")
    c12 = dict(zip(COUNTER_NAMES, counts12))
    print(f"  launches during the requests: {c12} (K6: 2 + 2 per layer, "
          f"{4 * L} per step x {steps12} steps: "
          f"{c12['K6 att'] + c12['K6 ffn'] == 4 * L * steps12}); K2 once per step")
    require(c12["K6 att"] > 0 and c12["K6 ffn"] > 0, "K6 never launched on the tp path")
    require(c12["K6 att"] == c12["K6 ffn"] == 2 * L * steps12,
            f"K6: {c12['K6 att']} + {c12['K6 ffn']} launches for {steps12} decoded steps, not "
            f"2 + 2 per layer each")
    require(c12["K2"] > 0, "the tp path's head never launched K2")
    require(all(c12[k] == 0 for k in ("K1", "K4", "K3", "K5 stack", "K5 head", "K7", "K7 q4")),
            f"the tp path launched another stack: {c12}")
    k6_att_launches, k6_ffn_launches = c12["K6 att"], c12["K6 ffn"]
    check_engine_logits(eng, cfg.vocab_size, ref_params=eng.params.rows[0][0])
    print(f"  decode ms/token graphed (eager): tp=1 halves engine {ms_per_token['tp=1'][0]:.3f} "
          f"({ms_per_token['tp=1'][1]:.3f}), K1 engine {ms_per_token['K1'][0]:.3f} "
          f"({ms_per_token['K1'][1]:.3f}, phase 4) {card}")

    def greedy(e, n=8):
        e.reset_state()
        logits = e.forward(e.tokenizer.encode(prompts[2]))
        first, ids = logits.clone(), []
        for _ in range(n):
            ids.append(int(logits.argmax()))
            logits = e.forward(ids[-1])
        return first, ids

    def eager_same(e, texts):
        """The 4-slot pool's six requests again with its decode eager: the
        same texts as graphed."""
        pool = InferencePool(e.params, e.tokenizer, max_streams=4, prefill_bucket=128,
                             step_fn=e._step_fn, prefill_fn=e._prefill_impl)
        pool._graphs.enabled = False
        rids = [pool.submit(**dict(r, max_tokens=16)) for r in reqs[:6]]
        out = pool.run()
        require([out[r] for r in rids] == texts, "the graphed pool's texts differ from the "
                 "eager pool's")
        print("  the pool's texts equal an eager pool's")

    l1, ids1 = greedy(eng)
    mesh2 = make_mesh(model=2, devices=[dev, dev])
    t0 = time.perf_counter()
    eng2 = RWKV(bin_path, sharding=mesh2, tp_body="halves")
    eng2.load_tokenizer()
    torch.cuda.synchronize()
    print(f"  virtual mesh model=2 (one card twice): loaded in {time.perf_counter() - t0:.1f} s, "
          f"body {eng2._step_fn.body}, att.key shard {tuple(eng2.params.rows[0][1].att.key.w.shape)}")
    l2, ids2 = greedy(eng2)
    err, serr = scaled_err(l2, l1)
    require(serr <= TP_TOL, f"tp=2 logits vs tp=1: scaled error {serr:.3e} > {TP_TOL}")
    require(ids1 == ids2, f"tp=2 greedy ids {ids2} differ from tp=1's {ids1}")
    mesh2.reset_collectives()
    eng2.forward(ids2[-1])
    torch.cuda.synchronize()
    want = {"psum": 2 * L + 1, "all_gather": L + 1}
    require(mesh2.collectives == want, f"collectives per step {mesh2.collectives}, want {want}")
    print(f"  tp=2 vs tp=1: logits max abs err {err:.2e} (scaled {serr:.1e} <= {TP_TOL}); "
          f"8 greedy ids equal {ids2}; collectives per step {mesh2.collectives} (3L + 2)")
    for mod, name in counters:
        setattr(mod, name, 0)
    pool = InferencePool(eng2.params, eng2.tokenizer, max_streams=4, prefill_bucket=128,
                         step_fn=eng2._step_fn, prefill_fn=eng2._prefill_impl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [pool.submit(**dict(r, max_tokens=16)) for r in reqs[:6]]
    out = pool.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(sorted(out) == sorted(rids) and all(isinstance(out[r], str) for r in rids),
            "the tp=2 pool did not finish every request")
    require(th.launches_att > 0 and th.launches_ffn > 0 and ds_mod.launches == 0,
            "the tp=2 pool did not run on K6 alone")
    require(len(pool._graphs) == 1, "the tp=2 pool's decode is not graphed")
    eager_same(eng2, [out[r] for r in rids])
    print(f"  4-slot pool over the tp=2 engine: 6 requests, 16 tokens each, all finished in "
          f"{wall:.2f} s (a correctness run on a virtual mesh, not a speed-up) {card}; "
          f"request 0 -> {out[rids[0]][:40]!r}")
    del eng, eng2, pool

    # ------------------------------------------------------------------ 13
    def k7_kwargs(params, tok, B):
        """K7's input: the tokens (B <= 8: the gather rides in the step) or x."""
        if B <= k7.FUSE_EMBED_MAX_B:
            return {"token": tok}
        return {"x": layer_norm(params.emb[tok], params.ln0.weight, params.ln0.bias)}

    def check_k7(params, cfg_, tps, batches, tag, steps=2):
        """K7 against its plain version for each tp and B over `steps` carried
        steps; at tp = 1 also against the unsharded step (K1 + K2 or K4 +
        K3); the last step's gathered logits of each tp against tp = 1's.
        Returns the worst absolute error over shards' logits and states."""
        V_ = cfg_.vocab_size
        sharded = {tp: shard_params(params, make_mesh(model=tp, devices=[dev] * tp))
                   for tp in tps}
        worst, k7_worst = {}, 0.0
        for B in batches:
            toks = [torch.from_numpy(rng.integers(0, V_, size=(B,))).to(dev)
                    for _ in range(steps)]
            first = None
            for tp in tps:
                sp = sharded[tp]
                local = [sp.local(0, j) for j in range(tp)]
                st_k = st_p = shard_state(init_state(cfg_, (B,), device=dev), sp.mesh)[0]
                st_u = init_state(cfg_, (B,), device=dev)
                for step, tok in enumerate(toks):
                    kw = k7_kwargs(params, tok, B)
                    before = k7.launches + k7.launches_q4
                    lg_k, n_k = k7.decode_stack_tp(sp.rows[0], st_k, local, **kw)
                    require(k7.launches + k7.launches_q4 == before + 1,
                            f"K7 {tag} tp={tp} B={B}: not one launch for the step")
                    lg_p, n_p = k7.decode_stack_tp_reference(sp.rows[0], st_p, local, **kw)
                    pairs = [(f"logits[{j}]", lg_k[j], lg_p[j]) for j in range(tp)]
                    pairs += [(f"{n}[{j}]", a, b) for j in range(tp)
                              for n, a, b in zip(WKVState._fields, n_k[j], n_p[j])]
                    if tp == 1:  # the unsharded step on the same params
                        lg_u, st_u = ds_mod.forward_step_fused(params, tok, st_u)
                        pairs.append(("logits vs unsharded", lg_k[0][:, :V_], lg_u[:, :V_]))
                        pairs += [(f"{n} vs unsharded", a, b)
                                  for n, a, b in zip(WKVState._fields, n_k[0], st_u)]
                    torch.cuda.synchronize()
                    for name, a, b in pairs:
                        require(bool(torch.isfinite(a).all()),
                                f"K7 {tag} tp={tp} B={B} step {step}: {name} not finite")
                        err, serr = scaled_err(a, b)
                        require(serr <= DECODE_TOL, f"K7 {tag} tp={tp} B={B} step {step}: "
                                f"{name} scaled error {serr:.3e} > {DECODE_TOL}")
                        key = (tp, name.split("[")[0])
                        worst[key] = max(worst.get(key, (0.0, 0.0)), (err, serr))
                        if "unsharded" not in name:
                            k7_worst = max(k7_worst, err)
                    st_k, st_p = n_k, n_p
                full = torch.cat(lg_k, dim=-1)[:, :V_]
                if first is None:
                    first = full
                    continue
                err, serr = scaled_err(full, first)
                require(serr <= DECODE_TOL, f"K7 {tag} tp={tp} B={B}: gathered logits vs tp=1 "
                        f"scaled error {serr:.3e} > {DECODE_TOL}")
                worst[tp, "gathered vs tp=1"] = max(worst.get((tp, "gathered vs tp=1"),
                                                              (0.0, 0.0)), (err, serr))
        for tp in tps:
            print(f"  {tag} tp={tp} (E/tp={cfg_.n_embd // tp}), B in {batches}, {steps} steps: "
                  "max abs err (scaled) " + ", ".join(
                      f"{n} {e:.2e} ({r:.1e})" for (t, n), (e, r) in worst.items() if t == tp))
        return k7_worst, sharded

    def time_k7(params, sharded, cfg_, tag):
        """ms per step of K7 at each tp (B = 1 and 8); at tp = 1 the
        unsharded step in turns with it, eager and replayed from a CUDA
        graph, the plain version and the bound. Returns the tp = 1, B = 1
        row."""
        L_, E_ = cfg_.n_layer, cfg_.n_embd
        head = params.head
        head_bytes = nbytes([head.wp if isinstance(head, Quant4Linear) else head.w])
        wb, vb = weight_bytes(params), vector_bytes(params)
        rows = {}
        for B in (1, 8):
            tok = torch.from_numpy(rng.integers(0, cfg_.vocab_size, size=(B,))).to(dev)
            for tp, sp in sharded.items():
                local = [sp.local(0, j) for j in range(tp)]
                st = shard_state(init_state(cfg_, (B,), device=dev), sp.mesh)[0]
                fused = lambda: k7.decode_stack_tp(sp.rows[0], st, local, token=tok)  # noqa: E731,B023,E501
                if tp > 1:
                    print(f"  {tag} tp={tp} B={B}: K7 {cuda_ms(fused, 20):.3f} ms/step on one "
                          f"card named {tp} times (a correctness run, not scaling) {card}")
                    continue
                st_u = init_state(cfg_, (B,), device=dev)
                unsharded = lambda: ds_mod.forward_step_fused(params, tok, st_u)  # noqa: E731,B023,E501
                t = {"unsharded": [], "K7": []}
                g = {"unsharded": [], "K7": []}
                for name in ("unsharded", "K7", "K7", "unsharded"):  # in turns
                    t[name].append(cuda_ms(fused if name == "K7" else unsharded, 20))
                for name in ("unsharded", "K7", "K7", "unsharded"):
                    g[name].append(graph_ms(fused if name == "K7" else unsharded, 20))
                g_ms = min(g["K7"])
                plain_ms = cuda_ms(lambda: k7.decode_stack_tp_reference(  # noqa: B023
                    sp.rows[0], st, local, token=tok), 3, warmup=1)
                # + B embedding rows, state in and out, the logits out
                nb = wb + vb + head_bytes + (B * E_ + 10 * L_ * B * E_ + B * head.out_features) * 4
                b_ms, b_by = bound(nb, 2 * B * (L_ * 13 * E_ * E_ + E_ * head.out_features))
                rows[B] = dict(ms=min(t["K7"]), plain_ms=plain_ms, graph_ms=g_ms, bound_ms=b_ms,
                               bound_by=b_by)
                grid = k7.stack_grid_tp(B, E_, q4=isinstance(head, Quant4Linear))
                fmt = lambda v: ", ".join(f"{x:.4f}" for x in v)  # noqa: E731
                print(f"  {tag} tp=1 B={B}: K7 {fmt(t['K7'])} ms/step, unsharded step "
                      f"{fmt(t['unsharded'])} (in turns: unsharded, K7, K7, unsharded); replayed "
                      f"from a CUDA graph in turns: K7 {fmt(g['K7'])}, unsharded "
                      f"{fmt(g['unsharded'])}; plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms "
                      f"({b_by}, {nb / 1e6:.1f} MB); one launch of {grid} blocks per step, "
                      f"{4 * L_} grid barriers {card}")
        return rows[1]

    print(f"phase 13 decode_stack_tp (K7) vs plain, 430M: L={L} E={E} F={F}, tp 1, 2, 4 on a "
          "virtual mesh, q8 and q4")
    params = params_to(signedize_params(random_quantized_params_np(
        cfg, seed=args.seed + 7, pad_multiple=512)), dev)
    k7_err, sharded = check_k7(params, cfg, (1, 2, 4), (1, 8, 16), "430M q8")
    k7_row = time_k7(params, sharded, cfg, "430M q8")
    del params, sharded
    blk4 = q4_pack_block(E, 4)
    params = params_to(random_quantized_params_np(cfg, seed=args.seed + 8, pad_multiple=512,
                                                  q4=True, q4_block=blk4), dev)
    print(f"  q4 params: row-parallel pack block {blk4}")
    k7q4_err, sharded = check_k7(params, cfg, (1, 2, 4), (1, 8, 16), "430M q4")
    k7q4_row = time_k7(params, sharded, cfg, "430M q4")
    del params, sharded
    cfg14 = RWKVConfig(n_layer=2, n_embd=5120, vocab_size=1000)
    for quant in ("q8", "q4"):
        host = random_quantized_params_np(cfg14, seed=args.seed + 9, pad_multiple=1024,
                                          q4=quant == "q4", q4_block=q4_pack_block(5120, 8))
        params = params_to(signedize_params(host), dev)
        check_k7(params, cfg14, (1, 8), (1, 8, 16), f"14B widths L=2 {quant}", steps=1)
        del host, params

    # ------------------------------------------------------------------ 14
    print("phase 14 fused tensor-parallel serving: RWKV(path, sharding=make_mesh(model=1), "
          "tp_body='fused'), 430M .bin")
    eng_k1 = RWKV(bin_path)
    eng_k1.load_tokenizer()
    _, ids_k1 = greedy(eng_k1)
    del eng_k1
    eng = RWKV(bin_path, sharding=make_mesh(model=1), tp_body="fused")
    eng.load_tokenizer()
    require(eng._step_fn.body == "fused" and eng.quant == "q8",
            f"the tp=1 engine runs body {eng._step_fn.body}, quant {eng.quant}")
    steps14, counts14 = serve(eng, label="fused tp=1")
    c14 = dict(zip(COUNTER_NAMES, counts14))
    k7_launches = c14["K7"]
    print(f"  launches during the requests: {c14} (K7: one per step x {steps14} steps: "
          f"{c14['K7'] == steps14})")
    require(k7_launches > 0, "K7 never launched on the fused path")
    require(k7_launches == steps14, f"K7: {k7_launches} launches for {steps14} decoded steps, "
            "not one each")
    require(all(c14[k] == 0 for k in COUNTER_NAMES if k != "K7"),
            f"the fused path launched another kernel: {c14}")
    check_engine_logits(eng, cfg.vocab_size, ref_params=eng.params.rows[0][0])
    _, ids_f1 = greedy(eng)
    require(ids_f1 == ids_k1, f"fused tp=1 greedy ids {ids_f1} differ from the K1 engine's {ids_k1}")
    print(f"  greedy ids equal the K1 engine's: {ids_k1}; decode ms/token graphed (eager), "
          "device busy graphed (eager), at chunk 1 and 8, by engine: " + "; ".join(
              f"{k} {a:.3f} ({b:.3f}), {c:.1%} ({d:.1%}), chunk 8 {e:.3f} ({f:.3f})"
              for k, (a, b, c, d, e, f) in ms_per_token.items())
          + f" {card}")
    mesh2 = make_mesh(model=2, devices=[dev, dev])
    eng2 = RWKV(bin_path, sharding=mesh2, tp_body="fused")
    eng2.load_tokenizer()
    require(eng2._step_fn.body == "fused", f"the tp=2 engine runs body {eng2._step_fn.body}")
    _, ids2 = greedy(eng2)
    require(ids2 == ids_k1, f"fused tp=2 greedy ids {ids2} differ from the K1 engine's {ids_k1}")
    mesh2.reset_collectives()
    eng2.forward(ids2[-1])
    torch.cuda.synchronize()
    want = {"psum": 0, "all_gather": 1}
    require(mesh2.collectives == want, f"collectives per step {mesh2.collectives}, want {want}")
    print(f"  virtual model=2 fused engine: 8 greedy ids equal {ids2}; collectives per step "
          f"{mesh2.collectives}")
    for mod, name in counters:
        setattr(mod, name, 0)
    pool = InferencePool(eng2.params, eng2.tokenizer, max_streams=4, prefill_bucket=128,
                         step_fn=eng2._step_fn, prefill_fn=eng2._prefill_impl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [pool.submit(**dict(r, max_tokens=16)) for r in reqs[:6]]
    out = pool.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c_pool = {n: getattr(mod, a) for n, (mod, a) in zip(COUNTER_NAMES, counters)}
    require(sorted(out) == sorted(rids) and all(isinstance(out[r], str) for r in rids),
            "the fused tp=2 pool did not finish every request")
    require(c_pool["K7"] > 0 and all(v == 0 for k, v in c_pool.items() if k != "K7"),
            f"the fused tp=2 pool did not run on K7 alone: {c_pool}")
    require(len(pool._graphs) == 1, "the fused tp=2 pool's decode is not graphed")
    eager_same(eng2, [out[r] for r in rids])
    print(f"  4-slot pool over the fused tp=2 engine: 6 requests, 16 tokens each, all finished "
          f"in {wall:.2f} s (a correctness run on a virtual mesh) {card}; launches {c_pool}; "
          f"request 0 -> {out[rids[0]][:40]!r}")
    del eng, eng2, pool
    host_q4 = random_quantized_params_np(cfg, seed=args.seed + 10, pad_multiple=512, q4=True,
                                         q4_block=512)
    eng_u = RWKV(quant="q4")
    eng_u.load_params(host_q4)
    eng_u.load_tokenizer()
    _, ids_u = greedy(eng_u)
    del eng_u
    mesh_q = make_mesh(model=2, devices=[dev, dev])
    eng_q = RWKV(sharding=mesh_q, quant="q4")
    eng_q.load_params(host_q4)
    eng_q.load_tokenizer()
    require(eng_q.quant == "q4" and eng_q._step_fn.body == "fused",
            f"the q4 mesh engine runs {eng_q.quant} on body {eng_q._step_fn.body}")
    for mod, name in counters:
        setattr(mod, name, 0)
    _, ids_q = greedy(eng_q)
    torch.cuda.synchronize()
    c_q = {n: getattr(mod, a) for n, (mod, a) in zip(COUNTER_NAMES, counters)}
    k7q4_launches = c_q["K7 q4"]
    require(ids_q == ids_u, f"q4 tp=2 greedy ids {ids_q} differ from the unsharded q4 engine's "
            f"{ids_u}")
    require(k7q4_launches > 0 and all(v == 0 for k, v in c_q.items() if k != "K7 q4"),
            f"the q4 tp=2 engine did not run on K7's q4 instantiation alone: {c_q}")
    print(f"  q4 engine on a virtual model=2 mesh (block 512): 8 greedy ids equal the unsharded "
          f"q4 engine's {ids_u}; launches {c_q}")
    del eng_q, host_q4

    # ------------------------------------------------------------------ 15
    print("phase 15 the apps on the card: bf16 prefill, eval, the HTTP server, storygen, "
          "vectordb, 430M .bin")
    t15 = time.perf_counter()
    import contextlib
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from rwkv_tpu_torch.apps import storygen as storygen_app
    from rwkv_tpu_torch.apps import vectordb as vectordb_app
    from rwkv_tpu_torch.apps.server import make_handler, make_server
    from rwkv_tpu_torch.eval import cli as eval_cli
    from rwkv_tpu_torch.tools.prefill_profile import prefill_report, print_report

    # no plain version may run on the card: count any call of them
    plain_calls = {"n": 0}

    def counting(fn):
        def spy(*a, **kw):
            plain_calls["n"] += 1
            return fn(*a, **kw)
        return spy

    plains = [(ds_mod, "decode_stack_plain"), (mm8_mod, "mm8_plain"), (mm4_mod, "mm4_plain")]
    saved_plains = [getattr(m, n) for m, n in plains]
    for m, n in plains:
        setattr(m, n, counting(getattr(m, n)))

    def run_main(main_fn, argv):
        """main(argv) of an app or the eval CLI, its stdout captured: (rc, text)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main_fn(argv)
        return rc, buf.getvalue()

    # 1. prefill: one 512-token chunk in f32 and bf16, timed and traced by op
    eng = RWKV(bin_path)
    rep = prefill_report(eng.params, 512, 10, args.seed)
    print_report(rep, 512, card)
    require(rep["finite"], "prefill logits are not finite")

    # 2. eval: the perplexity CLI on README.md, f32 and bf16
    readme = os.path.join(HERE, "README.md")
    nll = {}
    for extra in ([], ["--bf16"]):
        t0 = time.perf_counter()
        rc, text = run_main(eval_cli.main, ["--model", bin_path, "--text", readme,
                                            "--max-tokens", "2048"] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = json.loads(text.strip().splitlines()[-1])
        require(rc == 0 and out["tokens"] == 2047, f"eval {extra}: rc {rc}, {out}")
        name = "bf16" if extra else "f32"
        nll[name] = out["quant_nll"]
        print(f"  eval {name}: {out['tokens']} tokens, nll {out['quant_nll']:.6f}, ppl "
              f"{out['quant_ppl']:.1f}, {out['tokens'] / wall:.1f} tok/s with the load "
              f"({wall:.2f} s) {card}")
    dnll = abs(nll["bf16"] - nll["f32"])
    require(dnll < 0.05, f"eval: |NLL(bf16) - NLL(f32)| = {dnll:.3e} >= 0.05")
    print(f"  eval |NLL(bf16) - NLL(f32)| = {dnll:.3e} (< 0.05, tests/test_ppl.py's pin)")
    from rwkv_tpu_torch.eval.ppl import evaluate_nll
    from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer

    with open(readme, encoding="utf-8") as f:
        ids_readme = BPETokenizer.load().encode(f.read())[:2048]
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        evaluate_nll(eng.params, ids_readme[:512], compute_dtype=dt)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = evaluate_nll(eng.params, ids_readme, compute_dtype=dt)
        wall = time.perf_counter() - t0
        print(f"  evaluate_nll {name} on the loaded params (the .bin engine's int8 codes): "
              f"nll {r['nll']:.6f}, {r['tokens'] / wall:.1f} tok/s ({wall * 1e3:.1f} ms, "
              f"chunks of 256) {card}")

    # 3. the HTTP server: --bf16-prefill --pool 8 --pool-chunk 4 on 127.0.0.1:0
    del eng
    srv, eng, runner, _ = make_server(["--model", bin_path, "--bf16-prefill", "--pool", "8",
                                       "--pool-chunk", "4", "--port", "0"])
    require(eng.device.type == "cuda" and runner.pool.prefill_dtype == torch.bfloat16,
            "the server's engine or pool is not on the card with bf16 prefill")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_port}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=120) as r:
            return r.status, json.loads(r.read())

    def post(base, path, obj, raw=False):
        req = urllib.request.Request(base + path, json.dumps(obj).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            body = r.read().decode()
            return r.status, (body if raw else json.loads(body))

    code, health = get("/health")
    require(code == 200 and health["model"]["vocab"] == 50277, f"/health: {code} {health}")
    ids15 = eng.tokenizer.encode(" ".join(prompts) * 40)
    spec15 = [12, 300, 40, 130, 25, 260, 77, 200]  # prompt tokens
    reqs15 = [{"prompt": eng.tokenizer.decode(ids15[i * 7:i * 7 + n]), "max_tokens": 32,
               "temp": 0.9, "tau": 0.8, "seed": args.seed + 100 + i}
              for i, n in enumerate(spec15)]
    _, m0 = get("/metrics")
    admit_s = []  # host seconds in the pool's admissions (prefill + the first ids)
    admit = runner.pool._admit

    def timed_admit():
        t = time.perf_counter()
        try:
            return admit()
        finally:
            admit_s.append(time.perf_counter() - t)

    runner.pool._admit = timed_admit
    for mod, name in counters:
        setattr(mod, name, 0)
    plain_calls["n"] = 0
    results = {}

    def hit(i):
        results[i] = post(url, "/complete", reqs15[i])

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(reqs15))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    c15 = {n: getattr(mod, a) for n, (mod, a) in zip(COUNTER_NAMES, counters)}
    _, m1 = get("/metrics")
    require(sorted(results) == list(range(8)) and all(c == 200 for c, _ in results.values()),
            f"the pooled server did not answer every request: {results}")
    dc = {k: m1["counters"].get(k, 0) - m0["counters"].get(k, 0)
          for k in ("pool.tokens_decoded", "pool.requests_completed", "pool.steps")}
    require(dc["pool.requests_completed"] == 8 and dc["pool.tokens_decoded"] == 8 * 32,
            f"8 requests of 32 tokens each (no stop strings): counters moved by {dc}")
    require(c15["K1"] > 0 and c15["K2"] > 0 and all(v == 0 for k, v in c15.items()
                                                  if k not in ("K1", "K2")),
            f"the pooled server did not decode on K1 + K2 alone: {c15}")
    require(plain_calls["n"] == 0, f"a plain version ran {plain_calls['n']} times on the card")
    apps_launches = dict(c15)
    runner.pool._admit = admit
    busy_admit = [t for t in admit_s if t > 1e-3]  # the calls that admitted a burst
    print(f"  pooled server, 8 concurrent /complete (prompts {spec15} tokens, 32 new each): "
          f"{8 * 32 / wall:.1f} tok/s over all streams, {wall:.3f} s, {dc['pool.steps']:.0f} "
          f"pool steps of 4 tokens a slot, {wall / dc['pool.steps'] * 1e3:.2f} ms per step "
          f"with admission, {(wall - sum(admit_s)) / dc['pool.steps'] * 1e3:.2f} without; "
          f"admission {sum(admit_s) * 1e3:.1f} ms in {len(busy_admit)} bursts "
          f"({', '.join(f'{t * 1e3:.1f}' for t in busy_admit)} ms) {card}; launches {c15}; "
          f"plain calls 0")
    print(f"  request 0 -> {results[0][1]['completion'][:40]!r}")
    code, sse = post(url, "/complete", dict(reqs15[0], stream=True), raw=True)
    lines = [ln for ln in sse.splitlines() if ln.startswith("data: ")]
    require(code == 200 and lines and lines[-1] == "data: [DONE]"
            and all("text" in json.loads(ln[6:]) for ln in lines[:-1]),
            f"streaming /complete: {code} {sse[:200]!r}")
    code, tk = post(url, "/tokenize", {"text": "Hello world, from the card."})
    code2, dt = post(url, "/detokenize", {"ids": tk["ids"]})
    require(code == code2 == 200 and dt["text"] == "Hello world, from the card.",
            f"/tokenize round trip: {tk} {dt}")
    _, m2 = get("/metrics")
    require(m2["pool"]["slots"] == 8 and m2["counters"].get("pool.requests_completed", 0) >= 9,
            f"/metrics: {m2.get('pool')}")
    print(f"  streaming /complete: {len(lines) - 1} SSE pieces then [DONE]; /tokenize round "
          f"trip of {len(tk['ids'])} ids; /metrics pool {m2['pool']}")
    srv.shutdown()
    srv.server_close()
    require(runner.drain(timeout=60), "the pool did not drain")

    # the same engine behind a server without --pool: the engine's own generate
    srv2 = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(eng, threading.Lock()))
    threading.Thread(target=srv2.serve_forever, daemon=True).start()
    for mod, name in counters:
        setattr(mod, name, 0)
    code, one = post(f"http://127.0.0.1:{srv2.server_port}", "/complete", reqs15[2])
    c_one = {n: getattr(mod, a) for n, (mod, a) in zip(COUNTER_NAMES, counters)}
    srv2.shutdown()
    srv2.server_close()
    require(code == 200 and one["completion"], f"the plain server: {code} {one}")
    require(c_one["K1"] >= 31 and c_one["K2"] >= 31 and plain_calls["n"] == 0,
            f"the plain server's generate did not decode on K1 + K2: {c_one}")
    print(f"  server without --pool (generate, chunk 8): 200, launches {c_one}")
    del eng, runner, srv, srv2

    # 4. storygen and vectordb through their main(argv)
    for mod, name in counters:
        setattr(mod, name, 0)
    _, story = run_main(storygen_app.main, ["--model", bin_path, "--stories", "1",
                                            "--max-tokens", "32"])
    require("=== story 1 ===" in story and ds_mod.launches > 0 and mm8_mod.launches > 0,
            f"storygen: {story[:200]!r}")
    _, vdb = run_main(vectordb_app.main, ["--model", bin_path, "--batch-index",
                                          "--bf16-prefill"])
    ranked = [ln for ln in vdb.splitlines() if ln.startswith("  ")]
    require(len(ranked) == 3, f"vectordb: {vdb!r}")
    require(plain_calls["n"] == 0, f"a plain version ran {plain_calls['n']} times on the card")
    print(f"  storygen: {story.split('===')[-1].strip()[:40]!r}; vectordb --batch-index "
          f"--bf16-prefill top 3: {[ln.strip()[:30] for ln in ranked]}")
    for (m, n), f in zip(plains, saved_plains):
        setattr(m, n, f)
    print(f"  phase 15: {time.perf_counter() - t15:.1f} s")
    bin_dir.cleanup()

    # ------------------------------------------------------------------ 16
    print("phase 16 convert: a 430M bf16 .pth -> q8 .bin and q4 artifact, both served; "
          "TorchRWKV, the native tokenizer, sample_logits")
    t16 = time.perf_counter()
    import shutil

    from rwkv_tpu_torch.interop.torch import TorchRWKV
    from rwkv_tpu_torch.io.binfmt import read_bin
    from rwkv_tpu_torch.io.convert import load_checkpoint_quantized
    from rwkv_tpu_torch.models.rwkv4 import init_params
    from rwkv_tpu_torch.ops.sampling import nucleus_logits, sample_logits
    from rwkv_tpu_torch.tokenizer import assets as tok_assets
    from rwkv_tpu_torch.tokenizer import native as tok_native
    from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer

    conv_dir = tempfile.TemporaryDirectory(dir=_build.BUILD_DIR)
    pth = os.path.join(conv_dir.name, "rwkv4-430m-random-bf16.pth")
    conv_bin = os.path.join(conv_dir.name, "rwkv4-430m-random.bin")
    conv_q4 = os.path.join(conv_dir.name, "rwkv4-430m-random.q4.safetensors")

    # 1. a dense bf16 checkpoint with BlinkDL names, as RWKV-4 checkpoints ship
    t0 = time.perf_counter()
    dense = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), torch.bfloat16)

    def host(t):  # one storage a tensor, [out, in] weights contiguous
        return t.contiguous().cpu()

    sd = {"emb.weight": host(dense.emb), "head.weight": host(dense.head.t()),
          "ln_out.weight": host(dense.ln_out.weight), "ln_out.bias": host(dense.ln_out.bias),
          "blocks.0.ln0.weight": host(dense.ln0.weight),
          "blocks.0.ln0.bias": host(dense.ln0.bias)}
    for i in range(L):
        b = f"blocks.{i}."
        for n in ("ln1", "ln2"):
            sd[b + n + ".weight"] = host(getattr(dense, n).weight[i])
            sd[b + n + ".bias"] = host(getattr(dense, n).bias[i])
        for half, mixes in (("att", "kvr"), ("ffn", "kr")):
            for m in mixes:
                sd[b + f"{half}.time_mix_{m}"] = host(
                    getattr(getattr(dense, half), f"mix_{m}")[i].reshape(1, 1, E))
        sd[b + "att.time_decay"] = host(torch.log(-dense.att.decay[i].float()).bfloat16())
        sd[b + "att.time_first"] = host(dense.att.bonus[i])
        for m in ("key", "value", "receptance", "output"):
            sd[b + f"att.{m}.weight"] = host(getattr(dense.att, m)[i].t())
        for m in ("key", "value", "receptance"):
            sd[b + f"ffn.{m}.weight"] = host(getattr(dense.ffn, m)[i].t())
    del dense
    torch.save(sd, pth)
    del sd
    pth_mb = os.path.getsize(pth) / 1e6
    print(f"  wrote {pth_mb:.0f} MB bf16 .pth (init_params on a seeded generator, L={L} E={E} "
          f"F={F} V={cfg.vocab_size}) in {time.perf_counter() - t0:.1f} s")

    def child(argv):
        """python argv in a child process: (seconds, the child's peak RSS in MB
        from wait4, its largest RSS in MB sampled every 10 ms from /proc)."""
        import threading

        log = os.path.join(conv_dir.name, "child.log")
        sampled, stop = [0], threading.Event()

        def sample(pid):
            while not stop.is_set():
                try:
                    with open(f"/proc/{pid}/status") as f:
                        for line in f:
                            if line.startswith("VmRSS:"):
                                sampled[0] = max(sampled[0], int(line.split()[1]))
                except OSError:
                    pass
                stop.wait(0.01)

        t0 = time.perf_counter()
        with open(log, "w") as out:
            proc = subprocess.Popen([sys.executable, *argv], cwd=HERE, stdout=out,
                                    stderr=subprocess.STDOUT)
            poller = threading.Thread(target=sample, args=(proc.pid,))
            poller.start()
            _, status, ru = os.wait4(proc.pid, 0)
            stop.set()
            poller.join()
        proc.returncode = os.waitstatus_to_exitcode(status)
        secs = time.perf_counter() - t0
        with open(log) as f:
            text = f.read()
        require(proc.returncode == 0, f"python {argv}: exit {proc.returncode}\n{text[-2000:]}")
        return secs, ru.ru_maxrss / 1024, sampled[0] / 1024

    def convert_cli(argv):  # the converter's main(argv), as its command line runs it
        return child(["-m", "rwkv_tpu_torch.io.convert", *argv])

    import_s, import_rss, import_seen = child(["-c", "import rwkv_tpu_torch.io.convert"])

    # 2. convert to q8, and read the .bin back against the checkpoint quantized in memory
    secs, rss, seen = convert_cli([pth, "-o", conv_bin])
    print(f"  convert .pth -> q8 .bin ({os.path.getsize(conv_bin) / 1e6:.0f} MB): {secs:.1f} s "
          f"in a child process, {pth_mb / secs:.0f} MB/s of input; peak RSS (wait4) {rss:.0f} "
          f"MB, the largest sampled every 10 ms {seen:.0f} MB, beside the .pth's {pth_mb:.0f} "
          f"MB; a child that only imports the converter: {import_s:.1f} s, {import_rss:.0f} MB "
          f"(wait4), {import_seen:.0f} MB sampled (host figures) {card}")
    t0 = time.perf_counter()
    got = read_bin(conv_bin, "cpu", signed=True)
    want = signedize_params(load_checkpoint_quantized(pth, 8))
    got_l, want_l = [], []
    map_params(got, got_l.append)
    map_params(want, want_l.append)
    require(len(got_l) == len(want_l) == 40, f"{len(got_l)} vs {len(want_l)} leaves")
    for a, w_ in zip(got_l, want_l):
        w_ = torch.as_tensor(np.asarray(w_))
        require(a.dtype == w_.dtype and torch.equal(a, w_),
                f"read_bin(.bin) != load_checkpoint_quantized(.pth, 8) on a {tuple(a.shape)} "
                f"{a.dtype} leaf")
    del got, want, got_l, want_l
    print(f"  read_bin(.bin, signed) == load_checkpoint_quantized(.pth, 8) signed: every code, "
          f"scale, offset and vector, 40 leaves ({time.perf_counter() - t0:.1f} s)")

    for m, n in plains:  # no plain kernel version may run on the main path
        setattr(m, n, counting(getattr(m, n)))
    plain_calls["n"] = 0
    for mod, name in counters:
        setattr(mod, name, 0)
    c16 = {}

    def counts16():
        now = {n: getattr(mod, a) for n, (mod, a) in zip(COUNTER_NAMES, counters)}
        delta = {n: now[n] - c16.get(n, 0) for n in now}
        c16.update(now)
        return delta

    # 3. serve the q8 .bin
    t0 = time.perf_counter()
    eng16 = RWKV(conv_bin)
    eng16.load_tokenizer()
    require(eng16.device.type == "cuda" and eng16.quant == "q8", "the .bin did not load as q8")
    require(isinstance(eng16.tokenizer, tok_native.NativeBPETokenizer),
            f"RWKV.load_tokenizer() gave {type(eng16.tokenizer).__name__}, not the native one")
    texts = answer(eng16, 32, show=True)
    d = counts16()
    steps16 = len(prompts) * 31
    require(d["K1"] == per_step * steps16 and d["K2"] > 0 and d["K3"] == d["K4"] == 0,
            f"the converted .bin's requests: launches {d}")
    print(f"  RWKV(.bin) served 3 requests (32 new tokens each, graphed) in "
          f"{time.perf_counter() - t0:.1f} s with the load: launches K1 {d['K1']} (one per "
          f"decoded step), K2 {d['K2']}; {texts[0][:40]!r}")
    check_engine_logits(eng16, cfg.vocab_size)
    counts16()

    # 4. convert to q4 and serve the artifact
    secs4, rss4, seen4 = convert_cli([pth, "--quant", "q4", "-o", conv_q4])
    print(f"  convert .pth --quant q4 -> {os.path.getsize(conv_q4) / 1e6:.0f} MB artifact: "
          f"{secs4:.1f} s, {pth_mb / secs4:.0f} MB/s of input; peak RSS (wait4) {rss4:.0f} MB, "
          f"sampled {seen4:.0f} MB (host figures) {card}")
    eng4 = RWKV(conv_q4)
    eng4.load_tokenizer()
    require(eng4.quant == "q4" and isinstance(eng4.params.att.key, Quant4Linear),
            "the q4 artifact did not load as q4")
    texts4 = answer(eng4, 32)
    d = counts16()
    require(d["K4"] == per_step * steps16 and d["K3"] > 0 and d["K1"] == d["K2"] == 0,
            f"the converted q4 artifact's requests: launches {d}")
    print(f"  RWKV(q4 artifact) served 3 requests: launches K4 {d['K4']}, K3 {d['K3']}; "
          f"{texts4[0][:40]!r}")
    check_engine_logits(eng4, cfg.vocab_size)
    counts16()
    del eng4

    # 5. TorchRWKV over the converted .bin
    wrap = TorchRWKV(conv_bin)
    toks16 = eng16.tokenizer.encode(prompts[0] + " " + prompts[1])[:16]
    require(len(toks16) == 16, f"{len(toks16)} prompt tokens")
    state = wrap.empty_state()
    worst = 0.0
    for tok in toks16:
        kept = [s.clone() for s in state]
        logits_w, new = wrap.forward(tok, state)
        ref, _ = forward_step(wrap._eng.params, torch.tensor(tok, device=dev), WKVState(*state))
        torch.cuda.synchronize()
        require(logits_w.shape == (Vp,) and logits_w.device.type == "cuda",
                f"TorchRWKV logits {tuple(logits_w.shape)} on {logits_w.device}")
        require(all(torch.equal(a, b) for a, b in zip(state, kept)),
                "TorchRWKV.forward wrote the state passed in")
        serr = scaled_err(logits_w[:cfg.vocab_size], ref[:cfg.vocab_size])[1]
        require(serr <= DECODE_TOL, f"TorchRWKV logits vs plain: scaled error {serr:.3e}")
        worst = max(worst, serr)
        state = new
    d = counts16()
    require(d["K1"] == 16 and d["K2"] == 16, f"TorchRWKV's 16 forward calls: launches {d}")
    fwd_ms = cuda_ms(lambda: wrap.forward(toks16[0], state), 16)
    counts16()
    batch_toks = torch.tensor(toks16[:4], device=dev)
    lb, sb = wrap.forward_batch(batch_toks, [torch.stack([s] * 4, dim=1) for s in state])
    berr = 0.0
    for b in range(4):
        lr, sr = wrap.forward(toks16[b], state)
        berr = max([berr, scaled_err(lb[b], lr)[1]]
                   + [scaled_err(x[:, b], y)[1] for x, y in zip(sb, sr)])
    require(berr <= DECODE_TOL, f"forward_batch(B=4) vs four single streams: {berr:.3e}")
    # the state it returns, in an engine, decodes as an engine fed the same tokens
    nxt = int(logits_w[:cfg.vocab_size].argmax())

    def greedy16(first):
        ids = [first]
        for _ in range(15):
            ids.append(int(eng16.forward(ids[-1])[:cfg.vocab_size].argmax()))
        return ids

    eng16.reset_state()
    eng16.set_state(WKVState(*state))
    ids_w = greedy16(nxt)
    eng16.reset_state()
    for tok in toks16:
        lg = eng16.forward(tok)
    ids_e = greedy16(int(lg.argmax()))
    require(ids_w == ids_e, f"greedy ids from TorchRWKV's state {ids_w} != the engine's {ids_e}")
    d = counts16()
    print(f"  TorchRWKV(.bin): 16 forward calls on K1 + K2 (16 launches each), logits within "
          f"{worst:.1e} scaled of the plain model, the input state unchanged, {fwd_ms:.3f} ms "
          f"a call back to back {card}; forward_batch(B=4) "
          f"within {berr:.1e} of four single streams; its state in RWKV.set_state gives the "
          f"engine's 16 greedy ids")

    # 6. sample_logits on the card over [8, Vp] engine logits
    lg8, _ = wrap.forward_batch(torch.tensor(toks16[:8], device=dev),
                                [torch.stack([s] * 8, dim=1) for s in state])
    counts16()
    require(lg8.shape == (8, Vp), f"engine logits {tuple(lg8.shape)}")
    kept_dev = torch.isfinite(nucleus_logits(lg8, temp=0.7, top_p=0.9)).cpu()
    kept_cpu = torch.isfinite(nucleus_logits(lg8.cpu(), temp=0.7, top_p=0.9))
    require(torch.equal(kept_dev, kept_cpu), "sample_logits' kept set on the card != on the CPU")
    draws = [sample_logits(lg8, torch.Generator(device=dev).manual_seed(args.seed),
                           temp=0.7, top_p=0.9).cpu() for _ in range(2)]
    require(torch.equal(draws[0], draws[1]), "the same seed drew different ids")
    require(bool(kept_cpu[torch.arange(8), draws[0]].all()), "a draw outside the kept set")
    gen_s = torch.Generator(device=dev).manual_seed(args.seed)
    s_ms = cuda_ms(lambda: sample_logits(lg8, gen_s, temp=0.7, top_p=0.9), 20)
    print(f"  sample_logits(top_p 0.9, temp 0.7) over [8, {Vp}] engine logits: kept "
          f"{kept_cpu.sum(-1).tolist()} tokens a row, as on the CPU; the same seed draws the "
          f"same ids {draws[0].tolist()}; {s_ms:.4f} ms a call, eager {card}")
    require(plain_calls["n"] == 0, f"a plain version ran {plain_calls['n']} times on the card")
    for (m, n), f in zip(plains, saved_plains):
        setattr(m, n, f)
    convert_launches = {n: v for n, v in c16.items()}
    del wrap, eng16

    # 7. the native tokenizer, built here from csrc/tokenizer.cpp into a fresh directory
    build_dir = tok_native.BUILD_DIR
    tok_native.BUILD_DIR = _build.BUILD_DIR / "tok16"
    shutil.rmtree(tok_native.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    so = tok_native.build()
    build_s = time.perf_counter() - t0
    tok_native.BUILD_DIR = build_dir
    vocab16 = tok_assets.ensure_files(os.path.join(conv_dir.name, "vocab"))
    ntok = tok_native.NativeBPETokenizer(so, os.path.join(vocab16, "vocab.json"),
                                         os.path.join(vocab16, "merges.txt"))
    ptok = BPETokenizer.load()
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        readme_text = f.read()
    ids_n = ntok.encode(readme_text)
    require(ids_n == ptok.encode(readme_text), "native and Python encode differ on README.md")
    bad = [i for i in range(cfg.vocab_size) if ntok.decode_bytes([i]) != ptok.decode_bytes([i])]
    require(not bad, f"native decode differs from the Python one on ids {bad[:10]}")
    rates = {}  # README.md's tokens/s on a fresh tokenizer: the first pass, then 3 more
    for name, tk in (("native", tok_native.NativeBPETokenizer(
            so, os.path.join(vocab16, "vocab.json"), os.path.join(vocab16, "merges.txt"))),
            ("Python", BPETokenizer.load())):
        t0 = time.perf_counter()
        tk.encode(readme_text)
        t1 = time.perf_counter()
        for _ in range(3):
            tk.encode(readme_text)
        rates[name] = (len(ids_n) / (t1 - t0), 3 * len(ids_n) / (time.perf_counter() - t1))
    print(f"  native tokenizer: g++ build {build_s:.1f} s; README.md {len(ids_n)} ids equal to "
          f"the Python BPE's; all {cfg.vocab_size} ids decode to its bytes; encode tokens/s "
          f"(first pass, then with the merge cache filled): "
          + ", ".join(f"{n} {a:.0f}, {b:.0f}" for n, (a, b) in rates.items())
          + " (host figures); RWKV.load_tokenizer() gave the native one")
    conv_dir.cleanup()
    print(f"  phase 16: {time.perf_counter() - t16:.1f} s; launches on its main path (q8 and "
          f"q4 serving, TorchRWKV) {convert_launches}")

    kernels = [
        {"name": "decode_stack", "route": "cuda", "source": "rwkv_tpu_torch/csrc/decode_stack.cu",
         "replaces": "rwkv_tpu/ops/pallas/decode_stack.py:130", "launches": k1_launches,
         "max_abs_err": ds_rows[1]["err"], "ms": ds_rows[1]["ms"],
         "plain_ms": ds_rows[1]["plain_ms"], "bound_ms": ds_rows[1]["bound_ms"],
         "bound_by": ds_rows[1]["bound_by"], "library_ms": None,
         "shape": f"q8, B=1 L={L} E={E} F={F}, {per_step} launch per step ({4 * L} grid "
                  f"barriers); replayed from a CUDA graph {ds_rows[1]['graph_ms']:.4f} ms"},
        {"name": "mm8", "route": "cuda", "source": "rwkv_tpu_torch/csrc/mm8.cu",
         "replaces": "rwkv_tpu/ops/pallas/mm8.py:65", "launches": k2_launches,
         "max_abs_err": mm8_rows[1]["err"], "ms": mm8_rows[1]["ms"],
         "plain_ms": mm8_rows[1]["plain_ms"], "bound_ms": mm8_rows[1]["bound_ms"],
         "bound_by": mm8_rows[1]["bound_by"], "library_ms": mm8_rows[1]["lib_ms"],
         "shape": f"B=1 K={K} O={O}; ms the median of CUDA-graph replays, "
                  f"{mm8_rows[1]['eager_ms']:.4f} eager"},
        {"name": "mm4", "route": "cuda", "source": "rwkv_tpu_torch/csrc/mm4.cu",
         "replaces": "rwkv_tpu/ops/pallas/mm4.py:87", "launches": k3_launches,
         "max_abs_err": mm4_rows[1]["err"], "ms": mm4_rows[1]["ms"],
         "plain_ms": mm4_rows[1]["plain_ms"], "bound_ms": mm4_rows[1]["bound_ms"],
         "bound_by": mm4_rows[1]["bound_by"], "library_ms": mm4_rows[1]["lib_ms"],
         "shape": f"B=1 K={K} O={O}, packed [{K // 2}, {O}]; ms the median of CUDA-graph "
                  f"replays from HBM (6 weight copies), warm {mm4_rows[1]['warm_ms']:.4f}, "
                  f"{mm4_rows[1]['eager_ms']:.4f} eager; B=8 {mm4_rows[8]['ms']:.4f} "
                  f"(warm {mm4_rows[8]['warm_ms']:.4f}), B=16 {mm4_rows[16]['ms']:.4f} "
                  f"(warm {mm4_rows[16]['warm_ms']:.4f})"},
        {"name": "decode_stack_q4", "route": "cuda",
         "source": "rwkv_tpu_torch/csrc/decode_stack.cu",
         "replaces": "rwkv_tpu/ops/pallas/decode_stack.py:130", "launches": k4_launches,
         "max_abs_err": q4_rows[1]["err"], "ms": q4_rows[1]["ms"],
         "plain_ms": q4_rows[1]["plain_ms"], "bound_ms": q4_rows[1]["bound_ms"],
         "bound_by": q4_rows[1]["bound_by"], "library_ms": None,
         "shape": f"q4, B=1 L={L} E={E} F={F}, {per_step} launch per step ({4 * L} grid "
                  f"barriers); replayed from a CUDA graph {q4_rows[1]['graph_ms']:.4f} ms"},
        {"name": "mm8_a8", "route": "cuda", "source": "rwkv_tpu_torch/csrc/mm8_a8.cu",
         "replaces": "rwkv_tpu/ops/pallas/mm8.py:141", "launches": k5_head_launches,
         "max_abs_err": a8_rows[1]["err"], "ms": a8_rows[1]["ms"],
         "plain_ms": a8_rows[1]["plain_ms"], "bound_ms": a8_rows[1]["bound_ms"],
         "bound_by": a8_rows[1]["bound_by"], "library_ms": a8_rows[1]["lib_ms"],
         "shape": f"B=1 K={K} O={O}; library: torch._int_mm on 24 rows; ms the median of "
                  f"CUDA-graph replays, {a8_rows[1]['eager_ms']:.4f} eager"},
        {"name": "decode_stack_a8", "route": "cuda",
         "source": "rwkv_tpu_torch/csrc/decode_stack.cu",
         "replaces": "rwkv_tpu/ops/pallas/decode_stack.py:130", "launches": k5_stack_launches,
         "max_abs_err": a8_stack_rows[1]["err"], "ms": a8_stack_rows[1]["ms"],
         "plain_ms": a8_stack_rows[1]["plain_ms"], "bound_ms": a8_stack_rows[1]["bound_ms"],
         "bound_by": a8_stack_rows[1]["bound_by"], "library_ms": None,
         "shape": f"a8, B=1 L={L} E={E} F={F} a8_block {blk}, {per_step} launch per step "
                  f"({4 * L} grid barriers); replayed from a CUDA graph "
                  f"{a8_stack_rows[1]['graph_ms']:.4f} ms"},
        {"name": "att_half", "route": "cuda", "source": "rwkv_tpu_torch/csrc/tp_halves.cu",
         "replaces": "rwkv_tpu/ops/pallas/tp_halves.py:189", "launches": k6_att_launches,
         "max_abs_err": k6_err["att"], "ms": k6_rows[1]["att_ms"],
         "plain_ms": k6_rows[1]["att_plain"], "bound_ms": k6_rows[1]["att_bound"][0],
         "bound_by": k6_rows[1]["att_bound"][1], "library_ms": None,
         "shape": f"tp=1, B=1: E={E}, E_loc={E}, 2 cluster launches with PDL per call; ms per "
                  f"layer over all {L} layers replayed from a CUDA graph; one layer repeated "
                  f"(L2-hot) {k6_rows[1]['att_hot']:.4f} ms"},
        {"name": "ffn_half", "route": "cuda", "source": "rwkv_tpu_torch/csrc/tp_halves.cu",
         "replaces": "rwkv_tpu/ops/pallas/tp_halves.py:283", "launches": k6_ffn_launches,
         "max_abs_err": k6_err["ffn"], "ms": k6_rows[1]["ffn_ms"],
         "plain_ms": k6_rows[1]["ffn_plain"], "bound_ms": k6_rows[1]["ffn_bound"][0],
         "bound_by": k6_rows[1]["ffn_bound"][1], "library_ms": None,
         "shape": f"tp=1, B=1: E={E}, F_loc={F}, 2 cluster launches with PDL per call; ms per "
                  f"layer over all {L} layers replayed from a CUDA graph; one layer repeated "
                  f"(L2-hot) {k6_rows[1]['ffn_hot']:.4f} ms"},
        {"name": "decode_stack_tp", "route": "cuda", "source": "rwkv_tpu_torch/csrc/decode_stack_tp.cu",
         "replaces": "rwkv_tpu/ops/pallas/decode_stack_tp.py:519", "launches": k7_launches,
         "max_abs_err": k7_err, "ms": k7_row["ms"], "plain_ms": k7_row["plain_ms"],
         "bound_ms": k7_row["bound_ms"], "bound_by": k7_row["bound_by"], "library_ms": None,
         "shape": f"q8, tp=1, B=1, L={L} E={E} F={F}, head included, 1 launch per step "
                  f"({4 * L} grid barriers); replayed from a CUDA graph "
                  f"{k7_row['graph_ms']:.4f} ms"},
        {"name": "decode_stack_tp_q4", "route": "cuda",
         "source": "rwkv_tpu_torch/csrc/decode_stack_tp.cu",
         "replaces": "rwkv_tpu/ops/pallas/decode_stack_tp.py:519", "launches": k7q4_launches,
         "max_abs_err": k7q4_err, "ms": k7q4_row["ms"], "plain_ms": k7q4_row["plain_ms"],
         "bound_ms": k7q4_row["bound_ms"], "bound_by": k7q4_row["bound_by"], "library_ms": None,
         "shape": f"q4 (block {blk4}), tp=1, B=1, L={L} E={E} F={F}, head included, "
                  f"1 launch per step ({4 * L} grid barriers); replayed from a CUDA graph "
                  f"{k7q4_row['graph_ms']:.4f} ms"},
    ]
    counter_of = {"decode_stack": "K1", "mm8": "K2", "mm4": "K3", "decode_stack_q4": "K4",
                  "mm8_a8": "K5 head", "decode_stack_a8": "K5 stack", "att_half": "K6 att",
                  "ffn_half": "K6 ffn", "decode_stack_tp": "K7", "decode_stack_tp_q4": "K7 q4"}
    for k in kernels:  # phases 15 and 16's runs, each counted from 0 as the main path's
        k["launches_apps"] = apps_launches[counter_of[k["name"]]]
        k["launches_convert"] = convert_launches[counter_of[k["name"]]]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
