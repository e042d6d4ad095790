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
    from rwkv_tpu_torch.ops.cuda import mm8 as mm8_mod
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
    print(f"phase 3 decode_stack (K1) + head (K2) vs plain, 430M: L={L} E={E} F={F}")
    t0 = time.perf_counter()
    host_u8 = random_quantized_params_np(cfg, seed=args.seed, pad_multiple=512)
    params = params_to(signedize_params(host_u8), dev)
    Vp = params.head.w.shape[1]
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    layer_bytes = nbytes((params.att.key.w, params.att.value.w, params.att.receptance.w,
                          params.att.output.w, params.ffn.key.w, params.ffn.value.w,
                          params.ffn.receptance.w))
    # every f32 vector K1 reads once: norms, mixes, decay/bonus, scales/offsets
    leaves = []
    map_params(params, leaves.append)
    vec_bytes = nbytes(t for t in leaves if t.dtype == torch.float32 and t.dim() <= 2
                       and t is not params.emb and t is not params.logit_bias)
    print(f"  params ready in {time.perf_counter() - t0:.1f} s; layer weights "
          f"{layer_bytes / 1e6:.1f} MB, head {E * Vp / 1e6:.1f} MB")
    ds_rows = {}
    for B in (1, 8):
        st_k = init_state(cfg, (B,), device=dev)
        st_p = init_state(cfg, (B,), device=dev)
        worst = {}
        for step in range(4):
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
            y_k, n_k, xh_k, oh_k = ds_mod.decode_stack(params, tok, st_k)
            lg_k = mm8_mod.mm8(xh_k, params.head.w, row_add=oh_k, col_add=params.logit_bias)
            y_p, n_p, xh_p, oh_p = ds_mod.decode_stack_plain(params, tok, st_p)
            lg_p = mm8_mod.mm8_plain(xh_p, params.head.w, row_add=oh_p,
                                     col_add=params.logit_bias)
            torch.cuda.synchronize()
            pairs = dict(zip(("xy", "aa", "bb", "pp", "dd"), zip(n_k, n_p)))
            pairs.update(y=(y_k, y_p), xs_h=(xh_k, xh_p), off_h=(oh_k, oh_p),
                         logits=(lg_k[:, :cfg.vocab_size], lg_p[:, :cfg.vocab_size]))
            for name, (a, b) in pairs.items():
                require(bool(torch.isfinite(a).all()), f"decode B={B} step {step}: {name} "
                        "not finite")
                err, serr = scaled_err(a, b)
                require(serr <= DECODE_TOL, f"decode B={B} step {step}: {name} scaled error "
                        f"{serr:.3e} > {DECODE_TOL}")
                worst[name] = max(worst.get(name, (0.0, 0.0)), (err, serr))
            st_k, st_p = n_k, n_p
        print(f"  B={B}, 4 steps: max abs err (scaled <= {DECODE_TOL}): " + ", ".join(
            f"{n} {e:.2e} ({s:.1e})" for n, (e, s) in worst.items()))
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        st = init_state(cfg, (B,), device=dev)
        k1_ms = cuda_ms(lambda: ds_mod.decode_stack(params, tok, st), 20)
        step_ms = cuda_ms(lambda: ds_mod.forward_step_fused(params, tok, st), 20)
        plain_ms = cuda_ms(lambda: ds_mod.decode_stack_plain(params, tok, st), 5, warmup=1)
        # + B embedding rows, state in and out, y and xs_h out
        k1_bytes = layer_bytes + vec_bytes + (B * E + 10 * L * B * E + 2 * B * E + B) * 4
        b_ms, b_by = bound(k1_bytes, 2 * B * L * 13 * E * E)
        e2e_bytes = layer_bytes + E * Vp
        ds_rows[B] = dict(err=max(e for k, (e, _) in worst.items() if k != "logits"),
                          ms=k1_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"  B={B}: K1 {k1_ms:.3f} ms/step, K1+K2 step {step_ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms; K1 bound {b_ms:.4f} ms ({b_by}); step bound "
              f"{e2e_bytes / 1e6:.0f} MB: {e2e_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms at "
              f"3.35 TB/s, {e2e_bytes / bw * 1e3:.4f} ms at the measured copy rate {card}")
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
    ds_mod.launches = 0
    mm8_mod.launches = 0
    steps = 0
    rates = []
    for i, prompt in enumerate(prompts):
        eng.reset_state()
        n_prompt = len(eng.tokenizer.encode(prompt))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.load_context(prompt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        text = eng.generate("", max_tokens=32, temp=0.9, tau=0.8, seed=args.seed + i)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        steps += 31
        require(isinstance(text, str), "generate returned no text")
        rates.append((n_prompt / (t1 - t0), 32 / (t2 - t1)))
        print(f"  request {i}: prompt {n_prompt} tok, prefill {n_prompt / (t1 - t0):.1f} tok/s, "
              f"decode {32 / (t2 - t1):.1f} tok/s ({(t2 - t1) / 32 * 1e3:.2f} ms/token) "
              f"{card}; text {text[:60]!r}")
    k1_launches, k2_launches = ds_mod.launches, mm8_mod.launches
    print(f"  launches during the requests: decode_stack {k1_launches} "
          f"(= {per_step} per step x {steps} steps: {k1_launches == per_step * steps}), "
          f"mm8 {k2_launches}")
    require(k1_launches > 0, "decode_stack kernel never launched on the main path")
    require(k2_launches > 0, "mm8 kernel never launched on the main path")
    pf, dc = rates[-1]
    print(f"  last request: prefill {pf:.1f} tok/s, decode {dc:.1f} tok/s, "
          f"{1e3 / dc:.2f} ms/token {card}")

    # the engine's decode step on the loaded weights against the plain model
    eng.reset_state()
    eng.load_context(prompts[0])
    state = eng.get_state(0)
    logits = eng.forward(int(eng.tokenizer.encode(" It")[0]))
    ref, _ = forward_step(eng.params, torch.tensor(eng.tokenizer.encode(" It")[0], device=dev),
                          state)
    torch.cuda.synchronize()
    require(logits.shape == (cfg.vocab_size,), f"logits shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "engine logits not finite")
    err, serr = scaled_err(logits, ref[:cfg.vocab_size])
    require(serr <= DECODE_TOL, f"engine logits vs plain: scaled error {serr:.3e}")
    print(f"  engine decode logits vs plain forward_step: max abs err {err:.2e} "
          f"(scaled {serr:.1e} <= {DECODE_TOL}), argmax {int(logits.argmax())} == "
          f"{int(ref[:cfg.vocab_size].argmax())}")

    kernels = [
        {"name": "decode_stack", "route": "cuda", "source": "rwkv_tpu_torch/csrc/decode_stack.cu",
         "replaces": "rwkv_tpu/ops/pallas/decode_stack.py:130", "launches": k1_launches,
         "max_abs_err": ds_rows[1]["err"], "ms": ds_rows[1]["ms"],
         "plain_ms": ds_rows[1]["plain_ms"], "bound_ms": ds_rows[1]["bound_ms"],
         "bound_by": ds_rows[1]["bound_by"], "library_ms": None,
         "shape": f"B=1 L={L} E={E} F={F}, {per_step} launches per step"},
        {"name": "mm8", "route": "cuda", "source": "rwkv_tpu_torch/csrc/mm8.cu",
         "replaces": "rwkv_tpu/ops/pallas/mm8.py:65", "launches": k2_launches,
         "max_abs_err": mm8_rows[1]["err"], "ms": mm8_rows[1]["ms"],
         "plain_ms": mm8_rows[1]["plain_ms"], "bound_ms": mm8_rows[1]["bound_ms"],
         "bound_by": mm8_rows[1]["bound_by"], "library_ms": mm8_rows[1]["lib_ms"],
         "shape": f"B=1 K={K} O={O}"},
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
