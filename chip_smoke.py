#!/usr/bin/env python3
"""Smoke run of the rwkv_tpu_torch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and exits non-zero:

  1. device   nvidia-smi name + power limit; build every CUDA kernel from
              rwkv_tpu_torch/csrc (one nvcc per source, all at once); device
              memory bandwidth from a large device-to-device copy.
  2. mm8      kernel K2 against its plain version at the head shape
              [B, 1024] x [1024, 50688] int8, B in {1, 8}; times of the
              kernel, the plain version and one torch.matmul on the widened
              weight (the yardstick, never used by the port).
  3. decode   kernel K1 (+ K2 head) against the plain version at RWKV-4 430M
              widths (L=24, E=1024, F=4096, Vp=50688), weights from a numpy
              seed, B in {1, 8}, 4 consecutive steps: logits and all 5 state
              tensors; ms per step against the weight-bytes bound.
  4. e2e      write a 430M .bin with the port's write_bin, load it with
              RWKV(path) on the default device, answer 3 requests
              (load_context + generate(max_tokens=32)), check that both
              kernels' launch counters rose, and that the engine's logits
              match the plain model on the loaded weights.
  5. mm4      kernel K3 against its plain version at the q4 head shape
              [B, 1024] x packed [512, 50688], B in {1, 8}; times of the
              kernel, the plain version and one torch.matmul on the
              pre-widened f32 [1024, 50688] weight (the yardstick).
  6. decode4  kernel K4 (+ K3 head) against the plain version at 430M widths
              with packed 4-bit weights from a numpy seed (the default pairing
              block, 1024), B in {1, 8}, 4 steps, logits and all 5 state
              tensors; then at RWKV-4 7B widths (E=4096, F=16384, block 256)
              with L=2, where both row-tiled families pair within sub-K blocks.
  7. e2e4     write a 430M q4 artifact with the port's save_q4, load it with
              RWKV(path), check it runs as q4, answer 3 requests and check
              the K4 and K3 launch counters rose and the logits match the
              plain model; then load a dense f32 .safetensors at 430M width
              (L=2) with RWKV(path, quant="q4") and decode a few tokens.

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

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# float32 rate outside the tensor cores (the kernels accumulate in f32 FMAs).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# Tolerances, stated: fp32 sums over 1024..4096 terms in another order than
# torch.matmul's; scaled error = max|kernel - plain| / max(1, max|plain|).
MM8_TOL = 1e-5
MM4_TOL = 1e-5
DECODE_TOL = 1e-4


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
        forward_step,
        init_state,
        map_params,
        params_to,
        random_quantized_params_np,
        signedize_params,
    )
    from rwkv_tpu_torch.ops.cuda import _build
    from rwkv_tpu_torch.ops.cuda import decode_stack as ds_mod
    from rwkv_tpu_torch.ops.cuda import mm4 as mm4_mod
    from rwkv_tpu_torch.ops.cuda import mm8 as mm8_mod
    from rwkv_tpu_torch.ops.quant import Quant4Linear, unpack4
    from rwkv_tpu_torch.runtime.engine import RWKV

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
    for n in _build.KERNELS:
        for line in _build.build_log(n).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {n}: {line.strip()}")

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

    big = torch.empty(1 << 28, dtype=torch.float32, device=dev)  # 1 GiB
    dst = torch.empty_like(big)
    copy_ms = cuda_ms(lambda: dst.copy_(big), 10)
    bw = 2 * big.numel() * 4 / (copy_ms * 1e-3)
    del big, dst
    print(f"  device-to-device copy: {bw / 1e9:.1f} GB/s (read + write) {card}")

    def bound(nbytes: float, flops: float):
        tb, to = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
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
        ms = cuda_ms(lambda: mm8_mod.mm8(xs, w), 50)
        plain_ms = cuda_ms(lambda: mm8_mod.mm8_plain(xs, w), 20)
        lib_ms = cuda_ms(lambda: torch.matmul(xs, w_f32), 50)
        b_ms, b_by = bound(K * O + B * K * 4 + B * O * 4, 2 * B * K * O)
        bw_ms = K * O / bw * 1e3
        mm8_rows[B] = dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=b_ms,
                           bound_by=b_by)
        print(f"  B={B}: max abs err {err:.3e} (scaled {serr:.3e} <= {MM8_TOL}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul on widened W "
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
                y_k, n_k, xh_k, oh_k = ds_mod.decode_stack(params, tok, st_k)
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
            plain_ms = cuda_ms(lambda: ds_mod.decode_stack_plain(params, tok, st), 5, warmup=1)
            # + B embedding rows, state in and out, y and xs_h out
            ds_bytes = wb + vb + (B * E_ + 10 * L_ * B * E_ + 2 * B * E_ + B) * 4
            b_ms, b_by = bound(ds_bytes, 2 * B * L_ * 13 * E_ * E_)
            head = params.head
            head_bytes = nbytes([head.wp if isinstance(head, Quant4Linear) else head.w])
            step_bytes = wb + head_bytes
            rows[B].update(ms=ds_ms, step_ms=step_ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by)
            print(f"  {tag} B={B}: decode stack {ds_ms:.3f} ms/step, with head {step_ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms; stack bound {b_ms:.4f} ms ({b_by}, "
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
    ds_rows = check_decode(params, cfg, "q8")
    per_step = 6 * L + 1
    del params

    # ------------------------------------------------------------------ 4
    print("phase 4 end to end: RWKV(path).load_context + generate, 430M .bin")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "rwkv4-430m-random.bin")
        t0 = time.perf_counter()
        write_bin(path, host_u8)
        print(f"  wrote {os.path.getsize(path) / 1e6:.0f} MB in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        eng = RWKV(path)
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
        (mm4_mod, "launches")

    def serve(eng, max_tokens=32):
        """Answer the prompts with every launch count set to 0 just before;
        returns (decode steps, the counts just after: K1, K4, K2, K3)."""
        for mod, name in counters:
            setattr(mod, name, 0)
        steps, rates = 0, []
        for i, prompt in enumerate(prompts):
            eng.reset_state()
            n_prompt = len(eng.tokenizer.encode(prompt))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.load_context(prompt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            text = eng.generate("", max_tokens=max_tokens, temp=0.9, tau=0.8, seed=args.seed + i)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            steps += max_tokens - 1
            require(isinstance(text, str), "generate returned no text")
            rates.append((n_prompt / (t1 - t0), max_tokens / (t2 - t1)))
            print(f"  request {i}: prompt {n_prompt} tok, prefill {n_prompt / (t1 - t0):.1f} "
                  f"tok/s, decode {max_tokens / (t2 - t1):.1f} tok/s "
                  f"({(t2 - t1) / max_tokens * 1e3:.2f} ms/token) {card}; text {text[:60]!r}")
        counts = tuple(getattr(mod, name) for mod, name in counters)
        pf, dc = rates[-1]
        print(f"  last request: prefill {pf:.1f} tok/s, decode {dc:.1f} tok/s, "
              f"{1e3 / dc:.2f} ms/token {card}")
        return steps, counts

    def check_engine_logits(eng, vocab):
        """The engine's decode step on the loaded weights against the plain model."""
        eng.reset_state()
        eng.load_context(prompts[0])
        state = eng.get_state(0)
        tok = int(eng.tokenizer.encode(" It")[0])
        logits = eng.forward(tok)
        ref, _ = forward_step(eng.params, torch.tensor(tok, device=dev), state)
        torch.cuda.synchronize()
        require(logits.shape == (vocab,), f"logits shape {tuple(logits.shape)}")
        require(bool(torch.isfinite(logits).all()), "engine logits not finite")
        err, serr = scaled_err(logits, ref[:vocab])
        require(serr <= DECODE_TOL, f"engine logits vs plain: scaled error {serr:.3e}")
        print(f"  engine decode logits vs plain forward_step: max abs err {err:.2e} "
              f"(scaled {serr:.1e} <= {DECODE_TOL}), argmax {int(logits.argmax())} == "
              f"{int(ref[:vocab].argmax())}")

    steps, (k1_launches, k4_seen, k2_launches, k3_seen) = serve(eng)
    print(f"  launches during the requests: decode_stack q8 {k1_launches} "
          f"(= {per_step} per step x {steps} steps: {k1_launches == per_step * steps}), "
          f"mm8 {k2_launches}; q4 kernels {k4_seen}, {k3_seen}")
    require(k1_launches > 0, "decode_stack kernel never launched on the main path")
    require(k2_launches > 0, "mm8 kernel never launched on the main path")
    require(k4_seen == 0 and k3_seen == 0, "the q8 path launched a q4 kernel")
    check_engine_logits(eng, cfg.vocab_size)
    del eng

    # ------------------------------------------------------------------ 5
    print("phase 5 mm4 (K3) vs plain, [B, 1024] x packed [512, 50688] int8")
    wp = torch.from_numpy(rng.integers(-128, 128, size=(K // 2, O), dtype=np.int8)).to(dev)
    w_f32 = unpack4(wp).float()  # the yardstick's operand, prepared beforehand
    mm4_rows = {}
    for B in (1, 8):
        xs = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32) / 1000).to(dev)
        got = mm4_mod.mm4(xs, wp)
        ref = mm4_mod.mm4_plain(xs, wp)
        torch.cuda.synchronize()
        err, serr = scaled_err(got, ref)
        require(bool(torch.isfinite(got).all()), f"mm4 B={B}: non-finite output")
        require(serr <= MM4_TOL, f"mm4 B={B}: scaled error {serr:.3e} > {MM4_TOL}")
        ms = cuda_ms(lambda: mm4_mod.mm4(xs, wp), 50)
        plain_ms = cuda_ms(lambda: mm4_mod.mm4_plain(xs, wp), 20)
        lib_ms = cuda_ms(lambda: torch.matmul(xs, w_f32), 50)
        b_ms, b_by = bound(K * O // 2 + B * K * 4 + B * O * 4, 2 * B * K * O)
        mm4_rows[B] = dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=b_ms,
                           bound_by=b_by)
        print(f"  B={B}: max abs err {err:.3e} (scaled {serr:.3e} <= {MM4_TOL}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul on widened W "
              f"{lib_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, published peaks), "
              f"{K * O / 2 / bw * 1e3:.4f} ms at the measured copy rate; "
              f"{K * O / 2 / (ms * 1e-3) / 1e9:.0f} GB/s of packed weights {card}")
    del wp, w_f32

    # ------------------------------------------------------------------ 6
    print(f"phase 6 decode_stack q4 (K4) + head (K3) vs plain, 430M: L={L} E={E} F={F}")
    t0 = time.perf_counter()
    host_q4 = random_quantized_params_np(cfg, seed=args.seed + 1, pad_multiple=512, q4=True)
    params = params_to(host_q4, dev)
    print(f"  params ready in {time.perf_counter() - t0:.1f} s; packed layer weights "
          f"{weight_bytes(params) / 1e6:.1f} MB, head {params.head.wp.numel() / 1e6:.1f} MB; "
          f"blocks att.output {params.att.output.block}, ffn.value {params.ffn.value.block}")
    q4_rows = check_decode(params, cfg, "q4")
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
    steps4, (k1_seen, k4_launches, k2_seen, k3_launches) = serve(eng)
    print(f"  launches during the requests: decode_stack q4 {k4_launches} "
          f"(= {per_step} per step x {steps4} steps: {k4_launches == per_step * steps4}), "
          f"mm4 {k3_launches}; q8 kernels {k1_seen}, {k2_seen}")
    require(k4_launches > 0, "the q4 decode_stack kernel never launched on the q4 path")
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

    kernels = [
        {"name": "decode_stack", "route": "cuda", "source": "rwkv_tpu_torch/csrc/decode_stack.cu",
         "replaces": "rwkv_tpu/ops/pallas/decode_stack.py:130", "launches": k1_launches,
         "max_abs_err": ds_rows[1]["err"], "ms": ds_rows[1]["ms"],
         "plain_ms": ds_rows[1]["plain_ms"], "bound_ms": ds_rows[1]["bound_ms"],
         "bound_by": ds_rows[1]["bound_by"], "library_ms": None,
         "shape": f"q8, B=1 L={L} E={E} F={F}, {per_step} launches per step"},
        {"name": "mm8", "route": "cuda", "source": "rwkv_tpu_torch/csrc/mm8.cu",
         "replaces": "rwkv_tpu/ops/pallas/mm8.py:65", "launches": k2_launches,
         "max_abs_err": mm8_rows[1]["err"], "ms": mm8_rows[1]["ms"],
         "plain_ms": mm8_rows[1]["plain_ms"], "bound_ms": mm8_rows[1]["bound_ms"],
         "bound_by": mm8_rows[1]["bound_by"], "library_ms": mm8_rows[1]["lib_ms"],
         "shape": f"B=1 K={K} O={O}"},
        {"name": "mm4", "route": "cuda", "source": "rwkv_tpu_torch/csrc/mm4.cu",
         "replaces": "rwkv_tpu/ops/pallas/mm4.py:87", "launches": k3_launches,
         "max_abs_err": mm4_rows[1]["err"], "ms": mm4_rows[1]["ms"],
         "plain_ms": mm4_rows[1]["plain_ms"], "bound_ms": mm4_rows[1]["bound_ms"],
         "bound_by": mm4_rows[1]["bound_by"], "library_ms": mm4_rows[1]["lib_ms"],
         "shape": f"B=1 K={K} O={O}, packed [{K // 2}, {O}]"},
        {"name": "decode_stack_q4", "route": "cuda",
         "source": "rwkv_tpu_torch/csrc/decode_stack.cu",
         "replaces": "rwkv_tpu/ops/pallas/decode_stack.py:130", "launches": k4_launches,
         "max_abs_err": q4_rows[1]["err"], "ms": q4_rows[1]["ms"],
         "plain_ms": q4_rows[1]["plain_ms"], "bound_ms": q4_rows[1]["bound_ms"],
         "bound_by": q4_rows[1]["bound_by"], "library_ms": None,
         "shape": f"q4, B=1 L={L} E={E} F={F}, {per_step} launches per step"},
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
