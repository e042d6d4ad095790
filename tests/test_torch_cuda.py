"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

These need a CUDA device and skip without one. On the GPU machine, which has
no JAX, run them without the suite's conftest (it configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Shapes here are the odd ones that chip_smoke.py does not reach: batch rows
that do not fill a group of 8, column counts that do not fill a tile of 128,
contraction lengths that split unevenly across blocks, and 4-bit pairing
blocks from 2 rows to the whole contraction.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.rwkv4 import (
    WKVState,
    forward_step,
    init_state,
    params_to,
    random_quantized_params_np,
    signedize_params,
)
from rwkv_tpu_torch.ops.cuda import decode_stack as ds_mod
from rwkv_tpu_torch.ops.cuda import mm4 as mm4_mod
from rwkv_tpu_torch.ops.cuda import mm8 as mm8_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _scaled(a, b):
    return float((a.double() - b.double()).abs().max() / max(1.0, float(b.abs().max())))


# The int8 heads' shapes: odd ones, the 430M head (K = 1024) at the pool's
# batch sizes and past a pass of 16 rows, 14B's head at tp = 1 (K = 5120: the
# staged activations chunked) and its per-card half at tp = 4 (O = 12672:
# 99 column boxes for the card's SMs), K = 2048 with ragged columns.
HEAD_SHAPES = [(1, 64, 16), (3, 1000, 144), (8, 1536, 1040), (11, 4096, 256),
               (1, 1024, 50688), (2, 1024, 50688), (8, 1024, 50688), (16, 1024, 50688),
               (17, 1024, 50688), (24, 1024, 50688), (1, 5120, 50688), (16, 5120, 50688),
               (1, 5120, 12672), (8, 5120, 12672), (16, 2048, 1040), (5, 2048, 272)]


@pytest.mark.parametrize("B,K,O", HEAD_SHAPES)
def test_mm8_matches_plain(dev, B, K, O):
    rng = np.random.default_rng(B * 7 + K)
    xs = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32) / 100).to(dev)
    w = torch.from_numpy(rng.integers(-128, 128, size=(K, O), dtype=np.int8)).to(dev)
    row = torch.from_numpy(rng.normal(size=(B,)).astype(np.float32)).to(dev)
    col = torch.from_numpy(rng.normal(size=(O,)).astype(np.float32)).to(dev)
    before = mm8_mod.launches
    got = mm8_mod.mm8(xs, w, row_add=row, col_add=col)
    ref = mm8_mod.mm8_plain(xs, w, row_add=row, col_add=col)
    assert mm8_mod.launches == before + 1
    assert _scaled(got, ref) <= 1e-5
    # deterministic: each output summed in one order, no split of K
    assert torch.equal(mm8_mod.mm8(xs, w, row_add=row, col_add=col), got)


def test_mm8_rejects_uint8_and_odd_width(dev):
    xs = torch.zeros((1, 32), device=dev)
    with pytest.raises(TypeError):
        mm8_mod.mm8(xs, torch.zeros((32, 32), dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError):
        mm8_mod.mm8(xs, torch.zeros((32, 40), dtype=torch.int8, device=dev))


@pytest.fixture(scope="module")
def small():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = RWKVConfig(n_layer=2, n_embd=256, vocab_size=1000)
    p = params_to(signedize_params(random_quantized_params_np(cfg, seed=3, pad_multiple=128)),
                  torch.device("cuda", 0))
    return cfg, p


# Both sides of B* (ds_mod.TC_MIN_B: the tensor-core kernel from there to
# 16 rows, the CUDA-core one below) and a ragged last group of 4 rows.
@pytest.mark.parametrize("B", [1, 3, 4, 8, 9, 16])
def test_decode_stack_matches_plain(dev, small, B):
    cfg, p = small
    rng = np.random.default_rng(B)
    st_k = st_p = init_state(cfg, (B,), device=dev)
    tc = ds_mod.tc_path(B, cfg.n_embd, cfg.n_ffn, "q8")
    for _ in range(3):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        before = ds_mod.launches, ds_mod.launches_tc
        out_k = ds_mod.decode_stack(p, tok, st_k)
        # one launch a step, on the tensor cores where tc_path says so
        assert (ds_mod.launches, ds_mod.launches_tc) == (before[0] + 1, before[1] + tc)
        out_p = ds_mod.decode_stack_plain(p, tok, st_p)
        for a, b in zip(out_k[:1] + tuple(out_k[1]) + out_k[2:],
                        out_p[:1] + tuple(out_p[1]) + out_p[2:]):
            assert _scaled(a, b) <= 1e-4
        st_k, st_p = out_k[1], out_p[1]


def test_forward_step_fused_scalar_and_input_state_untouched(dev, small):
    cfg, p = small
    st = init_state(cfg, device=dev)
    st = type(st)(*(s + 0.01 * torch.arange(s.numel(), device=dev).reshape(s.shape) % 1
                    for s in st))
    keep = [s.clone() for s in st]
    logits, new = ds_mod.forward_step_fused(p, torch.tensor(17, device=dev), st)
    ref, ref_state = forward_step(p, torch.tensor(17, device=dev), st)
    assert logits.shape == (p.head.w.shape[1],)
    assert _scaled(logits[:cfg.vocab_size], ref[:cfg.vocab_size]) <= 1e-4
    for a, b in zip(new, ref_state):
        assert _scaled(a, b) <= 1e-4
    for a, b in zip(st, keep):
        assert torch.equal(a, b)


def test_decode_stack_rejects_strided_state(dev, small):
    cfg, p = small
    pool = init_state(cfg, (3,), device=dev)
    view = type(pool)(*(s[:, 1:2] for s in pool))
    with pytest.raises(ValueError, match="contiguous"):
        ds_mod.decode_stack(p, torch.tensor([5], device=dev), view)


@pytest.mark.parametrize("B,K,O,block", [(1, 64, 16, None), (3, 1000, 144, None),
                                         (8, 1536, 1040, 256), (11, 4096, 256, 1024),
                                         (5, 4096, 1024, 2), (2, 1024, 50688, None),
                                         (16, 1024, 50688, None), (17, 1024, 50688, None),
                                         (1, 4096, 50688, 256), (8, 4096, 50688, 256),
                                         (16, 4096, 50688, 256), (16, 2048, 16, 2),
                                         (4, 2048, 144, 256), (9, 2048, 16, 1024),
                                         (13, 1024, 144, None)])
def test_mm4_matches_plain(dev, B, K, O, block):
    rng = np.random.default_rng(B * 5 + K)
    xs = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32) / 100).to(dev)
    wp = torch.from_numpy(rng.integers(-128, 128, size=(K // 2, O), dtype=np.int8)).to(dev)
    row = torch.from_numpy(rng.normal(size=(B,)).astype(np.float32)).to(dev)
    col = torch.from_numpy(rng.normal(size=(O,)).astype(np.float32)).to(dev)
    before = mm4_mod.launches
    got = mm4_mod.mm4(xs, wp, block=block, row_add=row, col_add=col)
    ref = mm4_mod.mm4_plain(xs, wp, block=block, row_add=row, col_add=col)
    assert mm4_mod.launches == before + 1
    assert _scaled(got, ref) <= 1e-5
    # deterministic: every output is summed in a fixed order
    assert torch.equal(mm4_mod.mm4(xs, wp, block=block, row_add=row, col_add=col), got)


@pytest.mark.parametrize("B,K,O,block", [(3, 4096, 1040, 256), (16, 1024, 50688, None),
                                         (16, 4096, 144, 2)])
def test_mm4_wide_range_matches_plain(dev, B, K, O, block):
    """Activations over 40 binades, with zeros and both signs: the kernel's
    three bf16 pieces of each f32 value keep its products exact."""
    rng = np.random.default_rng(B * 3 + K)
    x = rng.choice([-1.0, 1.0], size=(B, K)) * 10.0 ** rng.uniform(-20, 20, size=(B, K))
    x[rng.random(size=(B, K)) < 0.1] = 0.0
    xs = torch.from_numpy(x.astype(np.float32)).to(dev)
    wp = torch.from_numpy(rng.integers(-128, 128, size=(K // 2, O), dtype=np.int8)).to(dev)
    got = mm4_mod.mm4(xs, wp, block=block)
    ref = mm4_mod.mm4_plain(xs, wp, block=block)
    assert bool(torch.isfinite(got).all())
    assert _scaled(got, ref) <= 1e-5
    assert torch.equal(mm4_mod.mm4(xs, wp, block=block), got)


def test_mm4_rejects_bad_block_and_dtype(dev):
    xs = torch.zeros((1, 64), device=dev)
    wp = torch.zeros((32, 32), dtype=torch.int8, device=dev)
    for block in (3, 48, 128):
        with pytest.raises(ValueError, match="block"):
            mm4_mod.mm4(xs, wp, block=block)
    with pytest.raises(TypeError):
        mm4_mod.mm4(xs, wp.to(torch.uint8))


@pytest.fixture(scope="module")
def small_q4():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = RWKVConfig(n_layer=2, n_embd=256, vocab_size=1000)
    host = random_quantized_params_np(cfg, seed=4, pad_multiple=128, q4=True)
    # the bytes are random, so any block tag is valid: block 64 gives
    # att.output 4 pairing blocks and ffn.value 16
    host.att.output = dataclasses.replace(host.att.output, block=64)
    host.ffn.value = dataclasses.replace(host.ffn.value, block=64)
    return cfg, params_to(host, torch.device("cuda", 0))


@pytest.mark.parametrize("B", [1, 3, 9])
def test_decode_stack_q4_matches_plain(dev, small_q4, B):
    cfg, p = small_q4
    rng = np.random.default_rng(B)
    st_k = st_p = init_state(cfg, (B,), device=dev)
    for _ in range(3):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        before = (ds_mod.launches, ds_mod.launches_q4)
        out_k = ds_mod.decode_stack(p, tok, st_k)
        assert (ds_mod.launches, ds_mod.launches_q4) == (before[0], before[1] + 1)
        out_p = ds_mod.decode_stack_plain(p, tok, st_p)
        for a, b in zip(out_k[:1] + tuple(out_k[1]) + out_k[2:],
                        out_p[:1] + tuple(out_p[1]) + out_p[2:]):
            assert _scaled(a, b) <= 1e-4
        again = ds_mod.decode_stack(p, tok, st_k)  # two launches, the same bits
        for a, b in zip(out_k[:1] + tuple(out_k[1]) + out_k[2:],
                        again[:1] + tuple(again[1]) + again[2:]):
            assert torch.equal(a, b)
        st_k, st_p = out_k[1], out_p[1]


def test_forward_step_fused_q4_runs_k4_and_k3(dev, small_q4):
    cfg, p = small_q4
    st = init_state(cfg, (2,), device=dev)
    tok = torch.tensor([17, 400], device=dev)
    before = (ds_mod.launches_q4, mm4_mod.launches, ds_mod.launches, mm8_mod.launches)
    logits, new = ds_mod.forward_step_fused(p, tok, st)
    after = (ds_mod.launches_q4, mm4_mod.launches, ds_mod.launches, mm8_mod.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0, 0]
    ref, ref_state = forward_step(p, tok, st)
    assert logits.shape == (2, p.head.wp.shape[1])
    assert _scaled(logits[:, :cfg.vocab_size], ref[:, :cfg.vocab_size]) <= 1e-4
    for a, b in zip(new, ref_state):
        assert _scaled(a, b) <= 1e-4


# W8A8 (kernel K5). A code is clip(round-half-even(v / s), -127, 127); the
# kernel and the plain version divide the same f32 numbers, so their codes
# are equal; the integer sums are exact and both round them to f32, scale
# and add in one order: the head is the plain version bit for bit.
@pytest.mark.parametrize("B,K,O", HEAD_SHAPES + [(16, 4096, 272)])
def test_mm8_a8_matches_plain(dev, B, K, O):
    rng = np.random.default_rng(B * 11 + K)
    xs = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32) / 100).to(dev)
    xs[0, :6] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])  # s = 1: ties at .5
    if B > 2:
        xs[2] = 0.0  # an all-zero row: the 1e-30 floor of the scale
    w = torch.from_numpy(rng.integers(-128, 128, size=(K, O), dtype=np.int8)).to(dev)
    row = torch.from_numpy(rng.normal(size=(B,)).astype(np.float32)).to(dev)
    col = torch.from_numpy(rng.normal(size=(O,)).astype(np.float32)).to(dev)
    before = mm8_mod.launches_a8
    got, codes, scale = mm8_mod.mm8_a8(xs, w, row_add=row, col_add=col, return_codes=True)
    assert mm8_mod.launches_a8 == before + 1
    q, s = mm8_mod.quant_rows(xs)
    assert torch.equal(codes, q) and torch.equal(scale, s)
    ref = mm8_mod.mm8_a8_plain(xs, w, row_add=row, col_add=col)
    assert torch.equal(got, ref)
    # the row maxima from the caller give the same result, and so does a second call
    again = mm8_mod.mm8_a8(xs, w, row_add=row, col_add=col, amax=xs.abs().amax(dim=1))
    assert torch.equal(again, got)
    assert torch.equal(mm8_mod.mm8_a8(xs, w, row_add=row, col_add=col), got)


def _head_operands(dev, B, K, O, seed):
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32) / 100).to(dev)
    w = torch.from_numpy(rng.integers(-128, 128, size=(K, O), dtype=np.int8)).to(dev)
    col = torch.from_numpy(rng.normal(size=(O,)).astype(np.float32)).to(dev)
    return xs, w, col


def test_int8_heads_launch_after_a_refused_one(dev):
    """A call the library refuses (a weight pointer off the TMA's 16-byte
    alignment, which the wrappers reject before the call) leaves no error
    behind: the next launch of each head runs, counts, and matches its
    plain version."""
    xs, w, col = _head_operands(dev, 3, 1024, 272, 31)
    buf = torch.zeros(1024 * 272 + 16, dtype=torch.int8, device=dev)
    out = torch.empty((3, 272), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib8, lib_a8 = mm8_mod._kernel(), mm8_mod._kernel_a8()
    err = lib8.rwkv_mm8(xs.data_ptr(), buf.data_ptr() + 1, out.data_ptr(), None, None, 3, 1024,
                        272, stream)
    assert err != 0
    err = lib_a8.rwkv_mm8_a8(xs.data_ptr(), buf.data_ptr() + 1, out.data_ptr(), None, None,
                             None, None, None, 3, 1024, 272, stream)
    assert err != 0
    before = (mm8_mod.launches, mm8_mod.launches_a8)
    got8 = mm8_mod.mm8(xs, w, col_add=col)
    got_a8 = mm8_mod.mm8_a8(xs, w, col_add=col)
    assert (mm8_mod.launches, mm8_mod.launches_a8) == (before[0] + 1, before[1] + 1)
    assert _scaled(got8, mm8_mod.mm8_plain(xs, w, col_add=col)) <= 1e-5
    assert torch.equal(got_a8, mm8_mod.mm8_a8_plain(xs, w, col_add=col))


@pytest.mark.parametrize("B", [1, 8, 16])
def test_int8_heads_in_a_cuda_graph(dev, B):
    """Both heads captured in one CUDA graph: a replay gives the eager bits,
    and a replay after the inputs change gives the new inputs' bits."""
    xs, w, col = _head_operands(dev, B, 1024, 50688, 40 + B)
    amax = xs.abs().amax(dim=1)
    run = lambda: (mm8_mod.mm8(xs, w, col_add=col), mm8_mod.mm8_a8(xs, w, col_add=col),  # noqa: E731
                   mm8_mod.mm8_a8(xs, w, col_add=col, amax=amax))
    run()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = run()
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        want = run()
        for a, b in zip(outs, want):
            assert torch.equal(a, b)
        xs.mul_(-1.5)
        amax.copy_(xs.abs().amax(dim=1))


def _a8_params(E, seed):
    cfg = RWKVConfig(n_layer=2, n_embd=E, vocab_size=1000)
    p = params_to(signedize_params(random_quantized_params_np(cfg, seed=seed, pad_multiple=128)),
                  torch.device("cuda", 0))
    return cfg, p


# The a8 stack against its plain version: the kernel repeats the plain
# version's arithmetic up to every quantization, so the codes, and the
# outputs, are the same (a rounding tie of a double sum aside): 1e-6 scaled.
# And the kernel must be much nearer the plain version at its own block than
# the plain versions at two blocks are to each other, which catches a kernel
# that ignores the block.
@pytest.mark.parametrize("E,block", [(256, 128), (1024, 512), (1024, 128)])
def test_decode_stack_a8_matches_plain(dev, E, block):
    cfg, p = _a8_params(E, seed=E + block)
    other = 2 * block if E % (2 * block) == 0 else block // 2
    rng = np.random.default_rng(block)
    B = 5
    st_k = st_p = init_state(cfg, (B,), device=dev)
    worst, apart = 0.0, 0.0
    for _ in range(3):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        before = (ds_mod.launches, ds_mod.launches_a8)
        out_k = ds_mod.decode_stack(p, tok, st_k, a8=True, a8_block=block)
        assert (ds_mod.launches, ds_mod.launches_a8) == (before[0], before[1] + 1)
        out_p = ds_mod.decode_stack_plain(p, tok, st_p, a8=True, a8_block=block)
        out_o = ds_mod.decode_stack_plain(p, tok, st_p, a8=True, a8_block=other)
        for a, b, c in zip(out_k[:1] + tuple(out_k[1]) + out_k[2:],
                           out_p[:1] + tuple(out_p[1]) + out_p[2:],
                           out_o[:1] + tuple(out_o[1]) + out_o[2:]):
            worst = max(worst, _scaled(a, b))
            apart = max(apart, _scaled(c, b))
        st_k, st_p = out_k[1], out_p[1]
    assert worst <= 1e-6, worst
    assert worst < apart / 4, (worst, apart)


def test_forward_step_fused_a8_runs_k5(dev):
    cfg, p = _a8_params(256, seed=7)
    st = init_state(cfg, (3,), device=dev)
    tok = torch.tensor([17, 400, 5], device=dev)
    counts = lambda: (ds_mod.launches, ds_mod.launches_a8, mm8_mod.launches,  # noqa: E731
                      mm8_mod.launches_a8)
    before = counts()
    logits, new = ds_mod.forward_step_fused(p, tok, st, a8=True, a8_block=128)
    assert [a - b for a, b in zip(counts(), before)] == [0, 1, 0, 1]
    _, ref_state, xs_h, off_h = ds_mod.decode_stack_plain(p, tok, st, a8=True, a8_block=128)
    ref = mm8_mod.mm8_a8_plain(xs_h, p.head.w, row_add=off_h, col_add=p.logit_bias)
    assert _scaled(logits[:, :cfg.vocab_size], ref[:, :cfg.vocab_size]) <= 1e-5
    assert torch.equal(logits.argmax(-1), ref.argmax(-1))
    for a, b in zip(new, ref_state):
        assert torch.equal(a, b)
    # head_a8: the q8 stack (K1) with the a8 head
    before = counts()
    logits_h, _ = ds_mod.forward_step_fused(p, tok, st, head_a8=True)
    assert [a - b for a, b in zip(counts(), before)] == [1, 0, 0, 1]
    _, _, xs_h, off_h = ds_mod.decode_stack_plain(p, tok, st)
    ref_h = mm8_mod.mm8_a8_plain(xs_h, p.head.w, row_add=off_h, col_add=p.logit_bias)
    assert _scaled(logits_h[:, :cfg.vocab_size], ref_h[:, :cfg.vocab_size]) <= 1e-5


def test_a8_step_independent_of_batchmates(dev):
    """Each batch row is quantized with its own scales, so a stream's a8 step
    gives the same bits whatever the other rows hold."""
    cfg, p = _a8_params(256, seed=8)
    rng = np.random.default_rng(8)
    st = init_state(cfg, (4,), device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4,))).to(dev)
    for _ in range(3):  # non-trivial states
        _, st = ds_mod.forward_step_fused(p, toks, st, a8=True, a8_block=128)
    lg4, st4 = ds_mod.forward_step_fused(p, toks, st, a8=True, a8_block=128)
    other = WKVState(*(s.clone() for s in st))
    for s in other:
        s[:, 1:] = s[:, 1:].flip(1) * 3.0
    toks2 = toks.clone()
    toks2[1:] = 999
    lg_o, st_o = ds_mod.forward_step_fused(p, toks2, other, a8=True, a8_block=128)
    assert torch.equal(lg4[0], lg_o[0])
    for a, b in zip(st4, st_o):
        assert torch.equal(a[:, 0], b[:, 0])


# Kernel K6 (csrc/tp_halves.cu): one layer's att and ffn halves per
# tensor-parallel shard, against their plain versions, at shard widths that
# are not powers of two (E / tp = 640, F / tp = 2560: the contraction splits
# of qmv.cuh must cover K = 640 exactly) and narrow (E / tp = 128); and the
# shards' partials, summed in the fixed order, against the tp = 1 call.
@pytest.fixture(scope="module")
def tp_setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import shard_params

    dev = torch.device("cuda", 0)
    cfg = RWKVConfig(n_layer=2, n_embd=1280, vocab_size=1000)
    p = params_to(signedize_params(random_quantized_params_np(cfg, seed=9, pad_multiple=640)),
                  dev)
    return cfg, {tp: shard_params(p, make_mesh(model=tp, devices=[dev] * tp))
                 for tp in (1, 2, 10)}


@pytest.mark.parametrize("tp", [2, 10])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_tp_halves_match_plain_and_sum_to_tp1(dev, tp_setup, tp, B):
    from rwkv_tpu_torch.ops.cuda import tp_halves as th

    cfg, sharded = tp_setup
    E, l = cfg.n_embd, 1
    El = E // tp
    rng = np.random.default_rng(tp * 10 + B)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)  # noqa: E731
    x, xy, dd, aa, pp = f(B, E), f(B, E), f(B, E), f(B, E), f(B, E)
    bb = f(B, E).abs() + 0.5
    full = sharded[1]
    att1 = th.att_half(full.rows[0][0], l, x, xy, aa, bb, pp, *full.local(0, 0))
    ffn1 = th.ffn_half(full.rows[0][0], l, x, dd)
    sp = sharded[tp]
    parts, vparts, gates = [], [], []
    for j in range(tp):
        p = sp.rows[0][j]
        cut = [t[:, j * El:(j + 1) * El].contiguous() for t in (aa, bb, pp)]
        before = (th.launches_att, th.launches_ffn, ds_mod.launches)
        got = th.att_half(p, l, x, xy, *cut, *sp.local(0, j))
        got_f = th.ffn_half(p, l, x, dd)
        assert (th.launches_att, th.launches_ffn, ds_mod.launches) == (before[0] + 2,
                                                                       before[1] + 2, before[2])
        want = th.att_half_plain(p, l, x, xy, *cut, *sp.local(0, j))
        want_f = th.ffn_half_plain(p, l, x, dd)
        for name, a, b in zip(("partial", "aa", "bb", "pp", "xx", "vpartial", "gate", "xx2"),
                              got + got_f, want + want_f):
            assert _scaled(a, b) <= 1e-5, (name, j, _scaled(a, b))
        for a, b in zip(got[1:4], att1[1:4]):  # the WKV step is per channel
            assert _scaled(a, b[:, j * El:(j + 1) * El]) <= 1e-5
        parts.append(got[0])
        vparts.append(got_f[0])
        gates.append(got_f[1])
    total, vtotal = parts[0], vparts[0]
    for a, b in zip(parts[1:], vparts[1:]):
        total, vtotal = total + a, vtotal + b
    assert _scaled(total, att1[0]) <= 1e-4
    assert _scaled(vtotal, ffn1[0]) <= 1e-4
    assert _scaled(torch.cat(gates, dim=1), ffn1[1]) <= 1e-5


def test_tp_step_halves_runs_k6_and_k2(dev, tp_setup):
    """The halves body on a virtual tp = 2 mesh: K6 and K2 launch, K1 does
    not, and the step matches the plain model."""
    from rwkv_tpu_torch.ops.cuda import tp_halves as th
    from rwkv_tpu_torch.parallel.tp_step import make_tp_step

    cfg, sharded = tp_setup
    sp = sharded[2]
    step = make_tp_step(sp.mesh, sp, body="halves")
    assert step.body == "halves"
    st = init_state(cfg, (3,), device=dev)
    tok = torch.tensor([17, 400, 5], device=dev)
    counts = lambda: (th.launches_att, th.launches_ffn, mm8_mod.launches, ds_mod.launches)  # noqa: E731
    before = counts()
    logits, new = step(sp, tok, st)
    L = cfg.n_layer
    assert [a - b for a, b in zip(counts(), before)] == [2 * L * 2, 2 * L * 2, 2, 0]
    ref, ref_state = forward_step(sharded[1].rows[0][0], tok, st)
    assert _scaled(logits[:, :cfg.vocab_size], ref[:, :cfg.vocab_size]) <= 1e-4
    for a, b in zip(new, ref_state):
        assert _scaled(a, b) <= 1e-4


def _halves_inputs(dev, B, E, El, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)  # noqa: E731
    x, xy, dd, aa, pp = f(B, E), f(B, E), f(B, E), f(B, El), f(B, El)
    return x, xy, dd, aa, f(B, El).abs() + 0.5, pp


def test_tp_halves_same_bits_and_graph_replay(dev, tp_setup):
    """Each half gives the same bits on two calls and from three replays of
    a CUDA graph that captured it (the cluster reduction sums in a fixed
    order, with no atomics); the inputs are never written."""
    from rwkv_tpu_torch.ops.cuda import tp_halves as th

    cfg, sharded = tp_setup
    sp = sharded[2]
    p, (decay, bonus) = sp.rows[0][1], sp.local(0, 1)
    E, El = cfg.n_embd, cfg.n_embd // 2
    x, xy, dd, aa, bb, pp = _halves_inputs(dev, 5, E, El, 3)
    keep = [t.clone() for t in (x, xy, dd, aa, bb, pp)]

    def call():
        return (th.att_half(p, 1, x, xy, aa, bb, pp, decay, bonus)
                + th.ffn_half(p, 1, x, dd))

    eager, again = call(), call()
    for a, b in zip(eager, again):
        assert torch.equal(a, b)
    for a, b in zip((x, xy, dd, aa, bb, pp), keep):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b)


def test_tp_step_halves_graph_equals_eager(dev, tp_setup):
    """The halves step on a mesh that names one card (tp = 1 and a virtual
    tp = 2) replays a CUDA graph from its second call: over 3 carried steps
    its logits and state are bit-equal to the eager body's, and each replay
    advances K6's and K2's launch counts and the mesh's collectives by one
    step's worth (2 + 2 K6 launches a layer and shard; 3L + 2 collectives at
    tp = 2)."""
    from rwkv_tpu_torch.ops.cuda import tp_halves as th
    from rwkv_tpu_torch.parallel.tp_step import make_tp_step

    cfg, sharded = tp_setup
    L = cfg.n_layer
    for tp in (1, 2):
        sp = sharded[tp]
        step = make_tp_step(sp.mesh, sp, body="halves")
        assert step.graphed
        st = st_e = init_state(cfg, (3,), device=dev)
        counts = lambda: (th.launches_att, th.launches_ffn, mm8_mod.launches,  # noqa: E731
                          ds_mod.launches, dict(sp.mesh.collectives))
        for i, tok in enumerate(([17, 400, 5], [3, 3, 999], [0, 64, 128])):
            tok = torch.tensor(tok, device=dev)
            before = counts()
            logits, st = step(sp, tok, st)
            after = counts()
            assert [a - b for a, b in zip(after[:4], before[:4])] == [2 * L * tp, 2 * L * tp,
                                                                      tp, 0], i
            want = {"psum": 2 * L + 1, "all_gather": L + 1} if tp > 1 else {"psum": 0,
                                                                             "all_gather": 0}
            assert {k: after[4][k] - before[4][k] for k in want} == want
            ref, st_e = step.eager(sp, tok, st_e)
            torch.cuda.synchronize()
            assert torch.equal(logits, ref), (tp, i)
            for a, b in zip(st, st_e):
                assert torch.equal(a, b), (tp, i)


def test_tp_halves_14b_widths_tp8(dev):
    """RWKV-4 14B widths (E = 5120, F = 20480), L = 2, at tp = 8 (E / tp =
    640 and F / tp = 2560: contractions that are not powers of two), B = 1
    and 8: every shard's halves against their plain versions, 2 + 2
    launches, and the summed partials against the tp = 1 call."""
    from rwkv_tpu_torch.ops.cuda import tp_halves as th
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import shard_params

    cfg = RWKVConfig(n_layer=2, n_embd=5120, vocab_size=1000)
    p = params_to(signedize_params(random_quantized_params_np(cfg, seed=43, pad_multiple=1024)),
                  dev)
    E, El, l = cfg.n_embd, cfg.n_embd // 8, 1
    full = shard_params(p, make_mesh(model=1, devices=[dev]))
    sp = shard_params(p, make_mesh(model=8, devices=[dev] * 8))
    del p
    for B in (1, 8):
        x, xy, dd, aa, bb, pp = _halves_inputs(dev, B, E, E, B)
        att1 = th.att_half(full.rows[0][0], l, x, xy, aa, bb, pp, *full.local(0, 0))
        ffn1 = th.ffn_half(full.rows[0][0], l, x, dd)
        total = vtotal = None
        for j in range(8):
            q = sp.rows[0][j]
            cut = [t[:, j * El:(j + 1) * El].contiguous() for t in (aa, bb, pp)]
            before = (th.launches_att, th.launches_ffn)
            got = th.att_half(q, l, x, xy, *cut, *sp.local(0, j)) + th.ffn_half(q, l, x, dd)
            assert (th.launches_att, th.launches_ffn) == (before[0] + 2, before[1] + 2)
            want = (th.att_half_plain(q, l, x, xy, *cut, *sp.local(0, j))
                    + th.ffn_half_plain(q, l, x, dd))
            for name, a, b in zip(("partial", "aa", "bb", "pp", "xx", "vpartial", "gate", "xx2"),
                                  got, want):
                assert torch.isfinite(a).all() and _scaled(a, b) <= 1e-5, (name, B, j,
                                                                           _scaled(a, b))
            total = got[0] if total is None else total + got[0]
            vtotal = got[5] if vtotal is None else vtotal + got[5]
        assert _scaled(total, att1[0]) <= 1e-4
        assert _scaled(vtotal, ffn1[0]) <= 1e-4


def test_tp_halves_long_contraction_in_passes(dev):
    """A width whose blocks' weight shares do not fit in shared memory at
    once (E = 8192, F = 32768, tp = 1: f1 runs unclustered with 8192 rows a
    block, f2 with 4096): each block sums its rows in passes, the later
    ones loaded after the first is summed. Both halves against their plain
    versions, B = 1 and 3."""
    from rwkv_tpu_torch.ops.cuda import tp_halves as th

    cfg = RWKVConfig(n_layer=1, n_embd=8192, vocab_size=1000)
    p = params_to(signedize_params(random_quantized_params_np(cfg, seed=47, pad_multiple=1024)),
                  dev)
    E, F = cfg.n_embd, cfg.n_ffn
    plan = th.plan(1, E, E, F)
    assert plan["f1"]["pass_rows"] < E and plan["f2"]["pass_rows"] < F // plan["f2"]["cluster"]
    for B in (1, 3):
        x, xy, dd, aa, bb, pp = _halves_inputs(dev, B, E, E, 47 + B)
        got = (th.att_half(p, 0, x, xy, aa, bb, pp, p.att.decay, p.att.bonus)
               + th.ffn_half(p, 0, x, dd))
        want = (th.att_half_plain(p, 0, x, xy, aa, bb, pp, p.att.decay, p.att.bonus)
                + th.ffn_half_plain(p, 0, x, dd))
        for name, a, b in zip(("partial", "aa", "bb", "pp", "xx", "vpartial", "gate", "xx2"),
                              got, want):
            assert torch.isfinite(a).all() and _scaled(a, b) <= 1e-5, (name, B, _scaled(a, b))


def test_tp_halves_plan_one_wave_at_430m(dev):
    """At RWKV-4 430M widths, tp = 1, B = 1, each of K6's four launches is a
    cluster launch whose blocks the card holds at once (one wave)."""
    from rwkv_tpu_torch.ops.cuda import tp_halves as th

    plan = th.plan(1, 1024, 1024, 4096)
    assert list(plan) == ["a1", "a2", "f1", "f2"]
    for name, row in plan.items():
        assert row["cluster"] in (1, 2, 4, 8), (name, row)
        assert row["blocks"] <= row["cluster"] * row["active_clusters"], (name, row)


def test_tp_halves_refused_launch_raises(dev, tp_setup):
    """A cluster launch the card refuses (more shared memory than a block
    may have, for the partial sums of a huge batch) raises, and counts no
    launch; no other route runs the half."""
    from rwkv_tpu_torch.ops.cuda import tp_halves as th

    cfg, sharded = tp_setup
    sp = sharded[1]
    B, E = 8192, cfg.n_embd
    x, xy, dd, aa, bb, pp = _halves_inputs(dev, B, E, E, 5)
    before = (th.launches_att, th.launches_ffn)
    with pytest.raises(RuntimeError, match="CUDA error"):
        th.att_half(sp.rows[0][0], 0, x, xy, aa, bb, pp, *sp.local(0, 0))
    with pytest.raises(RuntimeError, match="CUDA error"):
        th.ffn_half(sp.rows[0][0], 0, x, dd)
    assert (th.launches_att, th.launches_ffn) == before


def test_tp_halves_launch_after_a_refused_one(dev, tp_setup):
    """A refused K6 launch leaves no error behind: the next launch of the
    same kernel at a size it takes runs, counts, and matches its plain
    version (the refused call's error was left as the runtime's last error
    and reported by the next launch's check)."""
    from rwkv_tpu_torch.ops.cuda import tp_halves as th

    cfg, sharded = tp_setup
    p, E = sharded[1].rows[0][0], cfg.n_embd
    local = sharded[1].local(0, 0)
    x, xy, dd, aa, bb, pp = _halves_inputs(dev, 8192, E, E, 5)
    with pytest.raises(RuntimeError, match="CUDA error"):
        th.att_half(p, 0, x, xy, aa, bb, pp, *local)
    with pytest.raises(RuntimeError, match="CUDA error"):
        th.ffn_half(p, 0, x, dd)
    x, xy, dd, aa, bb, pp = _halves_inputs(dev, 3, E, E, 6)
    before = (th.launches_att, th.launches_ffn)
    got = th.att_half(p, 1, x, xy, aa, bb, pp, *local) + th.ffn_half(p, 1, x, dd)
    want = (th.att_half_plain(p, 1, x, xy, aa, bb, pp, *local)
            + th.ffn_half_plain(p, 1, x, dd))
    assert (th.launches_att, th.launches_ffn) == (before[0] + 2, before[1] + 2)
    for a, b in zip(got, want):
        assert _scaled(a, b) <= 1e-5


# Kernel K7 (csrc/decode_stack_tp.cu): the whole step of a data row's shards
# as one cooperative launch, q8 and q4, tp 1, 2 and 4 on a virtual mesh
# (E / tp = 512, 256, 128), B = 1 and 8 with the embedding gather in the step
# and B = 16 with x given, against its plain version over 2 carried steps.
@pytest.fixture(scope="module")
def k7_setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rwkv_tpu_torch.models.rwkv4 import q4_pack_block

    dev = torch.device("cuda", 0)
    cfg = RWKVConfig(n_layer=2, n_embd=512, vocab_size=1000)
    q8 = random_quantized_params_np(cfg, seed=11, pad_multiple=512)
    q4 = random_quantized_params_np(cfg, seed=12, pad_multiple=512, q4=True,
                                    q4_block=q4_pack_block(cfg.n_embd, 4))  # inside a shard
    return cfg, {"q8": params_to(signedize_params(q8), dev), "q4": params_to(q4, dev)}


@pytest.mark.parametrize("quant", ["q8", "q4"])
@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 8, 16])
def test_decode_stack_tp_matches_plain(dev, k7_setup, quant, tp, B):
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
    from rwkv_tpu_torch.ops.layernorm import layer_norm
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import shard_params, shard_state

    cfg, params = k7_setup
    p = params[quant]
    sp = shard_params(p, make_mesh(model=tp, devices=[dev] * tp))
    local = [sp.local(0, j) for j in range(tp)]
    st_k = st_p = shard_state(init_state(cfg, (B,), device=dev), sp.mesh)[0]
    rng = np.random.default_rng(tp * 100 + B)
    counter = "launches_q4" if quant == "q4" else "launches"
    for _ in range(2):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        kw = ({"token": tok} if B <= 8 else
              {"x": layer_norm(p.emb[tok], p.ln0.weight, p.ln0.bias).contiguous()})
        before = (k7.launches, k7.launches_q4, ds_mod.launches, mm8_mod.launches)
        lg_k, new_k = k7.decode_stack_tp(sp.rows[0], st_k, local, **kw)
        after = (k7.launches, k7.launches_q4, ds_mod.launches, mm8_mod.launches)
        moved = [a - b for a, b in zip(after, before)]
        assert moved == ([0, 1] if quant == "q4" else [1, 0]) + [0, 0], (counter, moved)
        lg_p, new_p = k7.decode_stack_tp_reference(sp.rows[0], st_p, local, **kw)
        torch.cuda.synchronize()
        for j in range(tp):
            assert _scaled(lg_k[j], lg_p[j]) <= 1e-4, ("logits", j, _scaled(lg_k[j], lg_p[j]))
            for name, a, b in zip(WKVState._fields, new_k[j], new_p[j]):
                assert torch.isfinite(a).all() and _scaled(a, b) <= 1e-4, (name, j, _scaled(a, b))
        st_k, st_p = new_k, new_p


def test_tp_step_fused_runs_k7_alone(dev, k7_setup):
    """The auto body on a virtual tp = 2 mesh is "fused": K7 launches, K6, K2
    and K1 do not, and the step matches the plain model with 1 gather and no
    psum."""
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
    from rwkv_tpu_torch.ops.cuda import tp_halves as th
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import shard_params
    from rwkv_tpu_torch.parallel.tp_step import make_tp_step

    cfg, params = k7_setup
    p = params["q8"]
    sp = shard_params(p, make_mesh(model=2, devices=[dev, dev]))
    step = make_tp_step(sp.mesh, sp)
    assert step.body == "fused"
    st = init_state(cfg, (3,), device=dev)
    tok = torch.tensor([17, 400, 5], device=dev)
    counts = lambda: (k7.launches, th.launches_att, th.launches_ffn, mm8_mod.launches,  # noqa: E731
                      ds_mod.launches)
    before = counts()
    sp.mesh.reset_collectives()
    logits, new = step(sp, tok, st)
    assert [a - b for a, b in zip(counts(), before)] == [1, 0, 0, 0, 0]
    assert sp.mesh.collectives == {"psum": 0, "all_gather": 1}
    ref, ref_state = forward_step(p, tok, st)
    assert _scaled(logits[:, :cfg.vocab_size], ref[:, :cfg.vocab_size]) <= 1e-4
    for a, b in zip(new, ref_state):
        assert _scaled(a, b) <= 1e-4


def _k7_call(sp, st, tok, **kw):
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7

    local = [sp.local(0, j) for j in range(len(sp.rows[0]))]
    lg, new = k7.decode_stack_tp(sp.rows[0], st, local, token=tok, **kw)
    return list(lg) + [t for s in new for t in s]


@pytest.mark.parametrize("quant", ["q8", "q4"])
@pytest.mark.parametrize("tp", [1, 2])
def test_decode_stack_tp_same_bits_and_graph_replay(dev, k7_setup, quant, tp):
    """Two calls give the same bits, and so do three replays of a CUDA graph
    that captured the launch (the barrier and split-K words are left at zero
    by every launch); the input state is never written."""
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import shard_params, shard_state

    cfg, params = k7_setup
    sp = shard_params(params[quant], make_mesh(model=tp, devices=[dev] * tp))
    B = 5
    tok = torch.from_numpy(np.random.default_rng(tp).integers(0, cfg.vocab_size, size=(B,))).to(dev)
    st = shard_state(init_state(cfg, (B,), device=dev), sp.mesh)[0]
    for _ in range(2):  # a state that is not all zeros
        out = _k7_call(sp, st, tok)
        st = [WKVState(*out[tp + 5 * j:tp + 5 * (j + 1)]) for j in range(tp)]
    keep = [t.clone() for s in st for t in s]
    eager = _k7_call(sp, st, tok)
    again = _k7_call(sp, st, tok)
    for a, b in zip(eager, again):
        assert torch.equal(a, b)
    for a, b in zip((t for s in st for t in s), keep):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _k7_call(sp, st, tok)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b)


@pytest.mark.parametrize("quant", ["q8", "q4"])
def test_decode_stack_tp_14b_widths_tp8(dev, quant):
    """RWKV-4 14B widths (E = 5120, F = 20480), L = 2, at tp = 8 (E / tp =
    640, F / tp = 2560, 128 vocab columns a shard), q4 packed in blocks that
    lie inside a shard: one launch a step, against the plain version."""
    from rwkv_tpu_torch.models.rwkv4 import q4_pack_block
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import shard_params, shard_state

    cfg = RWKVConfig(n_layer=2, n_embd=5120, vocab_size=1000)
    host = random_quantized_params_np(cfg, seed=41, pad_multiple=1024, q4=quant == "q4",
                                      q4_block=q4_pack_block(cfg.n_embd, 8))
    p = params_to(signedize_params(host), dev)
    del host
    sp = shard_params(p, make_mesh(model=8, devices=[dev] * 8))
    local = [sp.local(0, j) for j in range(8)]
    rng = np.random.default_rng(41)
    B = 3
    st_k = st_p = shard_state(init_state(cfg, (B,), device=dev), sp.mesh)[0]
    for _ in range(2):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        before = k7.launches + k7.launches_q4
        lg_k, new_k = k7.decode_stack_tp(sp.rows[0], st_k, local, token=tok)
        assert k7.launches + k7.launches_q4 == before + 1
        lg_p, new_p = k7.decode_stack_tp_reference(sp.rows[0], st_p, local, token=tok)
        torch.cuda.synchronize()
        for j in range(8):
            assert _scaled(lg_k[j], lg_p[j]) <= 1e-4, ("logits", j, _scaled(lg_k[j], lg_p[j]))
            for name, a, b in zip(WKVState._fields, new_k[j], new_p[j]):
                assert torch.isfinite(a).all() and _scaled(a, b) <= 1e-4, (name, j, _scaled(a, b))
        st_k, st_p = new_k, new_p


def test_decode_stack_tp_stamps_and_grid(dev, k7_setup):
    """K7's %globaltimer stamps: 4 L + 2 of them, in order, and the same bits
    with or without them; the grid is the occupancy API's blocks per SM
    times the SMs."""
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import shard_params, shard_state

    cfg, params = k7_setup
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = k7.stack_grid_tp(1, cfg.n_embd)
    assert grid >= sms and grid % sms == 0
    sp = shard_params(params["q8"], make_mesh(model=2, devices=[dev, dev]))
    st = shard_state(init_state(cfg, (1,), device=dev), sp.mesh)[0]
    tok = torch.tensor([7], device=dev)
    stamps = torch.zeros(4 * cfg.n_layer + 2, dtype=torch.int64, device=dev)
    plain = _k7_call(sp, st, tok)
    stamped = _k7_call(sp, st, tok, stamps=stamps)
    for a, b in zip(plain, stamped):
        assert torch.equal(a, b)
    t = stamps.cpu()
    assert bool((t > 0).all()) and bool((t[1:] >= t[:-1]).all())
    with pytest.raises(ValueError, match="stamps"):
        _k7_call(sp, st, tok, stamps=stamps[:3])


def test_decode_stack_tp_refused_launch_raises(dev, k7_setup):
    """A launch the card refuses (more shared memory than a block may have,
    for the [3, B] offset terms of a huge batch) raises; no other route runs
    the step."""
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import shard_params, shard_state

    cfg, params = k7_setup
    sp = shard_params(params["q8"], make_mesh(model=1, devices=[dev]))
    B = 8192
    st = shard_state(init_state(cfg, (B,), device=dev), sp.mesh)[0]
    x = torch.zeros((B, cfg.n_embd), device=dev)
    before = (k7.launches, k7.launches_q4)
    with pytest.raises(RuntimeError, match="CUDA error"):
        k7.decode_stack_tp(sp.rows[0], st, [sp.local(0, 0)], x=x)
    assert (k7.launches, k7.launches_q4) == before


# The decode stack as one persistent, cooperative launch a step (q8 K1, q4
# K4, a8 K5's stack): one launch, the same bits on two calls and from a
# CUDA graph's replay, batch rows that do not fill a group of 4, and the a8
# state bit-equal to the plain a8 version (the kernel repeats its arithmetic
# up to every quantization; csrc/decode_stack.cu).
@pytest.fixture(scope="module")
def stack_params():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = RWKVConfig(n_layer=2, n_embd=256, vocab_size=1000)
    q8 = params_to(signedize_params(random_quantized_params_np(cfg, seed=21, pad_multiple=128)),
                   dev)
    q4 = params_to(random_quantized_params_np(cfg, seed=22, pad_multiple=128, q4=True,
                                              q4_block=64), dev)
    return cfg, {"q8": q8, "q4": q4, "a8": q8}


_COUNTER = {"q8": "launches", "q4": "launches_q4", "a8": "launches_a8"}


def _stack(p, tok, st, fmt, **kw):
    return ds_mod.decode_stack(p, tok, st, a8=fmt == "a8", a8_block=128 if fmt == "a8" else None,
                               **kw)


def _flat(out):
    return (out[0],) + tuple(out[1]) + tuple(out[2:])


@pytest.mark.parametrize("fmt", ["q8", "q4", "a8"])
@pytest.mark.parametrize("B", [1, 3, 9, 16])
def test_decode_stack_one_launch_same_bits(dev, stack_params, fmt, B):
    cfg, params = stack_params
    p = params[fmt]
    rng = np.random.default_rng(B * 3 + len(fmt))
    st_k = st_p = init_state(cfg, (B,), device=dev)
    for _ in range(4):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        keep = [s.clone() for s in st_k]
        before = {k: getattr(ds_mod, k) for k in _COUNTER.values()}
        out_k = _stack(p, tok, st_k, fmt)
        moved = {k: getattr(ds_mod, k) - v for k, v in before.items()}
        assert moved == {k: int(k == _COUNTER[fmt]) for k in before}, moved
        again = _stack(p, tok, st_k, fmt)
        for a, b in zip(_flat(out_k), _flat(again)):
            assert torch.equal(a, b)
        for a, b in zip(st_k, keep):  # the input state is never written
            assert torch.equal(a, b)
        out_p = ds_mod.decode_stack_plain(p, tok, st_p, a8=fmt == "a8",
                                          a8_block=128 if fmt == "a8" else None)
        if fmt == "a8":
            for a, b in zip(out_k[1], out_p[1]):
                assert torch.equal(a, b)
        for a, b in zip(_flat(out_k), _flat(out_p)):
            assert _scaled(a, b) <= 1e-4
        st_k, st_p = out_k[1], out_p[1]


@pytest.mark.parametrize("fmt", ["q8", "q4", "a8"])
def test_decode_stack_graph_replay_equals_eager(dev, stack_params, fmt):
    cfg, params = stack_params
    p = params[fmt]
    B = 5
    rng = np.random.default_rng(len(fmt))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
    st = init_state(cfg, (B,), device=dev)
    for _ in range(2):  # a state that is not all zeros
        st = _stack(p, tok, st, fmt)[1]
    eager = _stack(p, tok, st, fmt)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _stack(p, tok, st, fmt)
    for _ in range(3):  # replays reuse the barrier's words with no reset
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(_flat(captured), _flat(eager)):
            assert torch.equal(a, b)
    assert torch.equal(_stack(p, tok, st, fmt)[0], eager[0])


@pytest.mark.parametrize("B", [1, 5])
def test_decode_stack_a8_long_splits_bit_equal(dev, B):
    """At 430M widths (E = 1024, F = 4096) the ffn matvecs' splits are longer
    than one 128-row group (qmv.cuh's long path); the a8 state stays
    bit-equal to the plain version's (csrc/qmv.cuh: a8_exact_long)."""
    cfg, p = _a8_params(1024, seed=31 + B)
    rng = np.random.default_rng(31 + B)
    st_k = st_p = init_state(cfg, (B,), device=dev)
    for _ in range(3):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        out_k = ds_mod.decode_stack(p, tok, st_k, a8=True, a8_block=512)
        out_p = ds_mod.decode_stack_plain(p, tok, st_p, a8=True, a8_block=512)
        for a, b in zip(out_k[1], out_p[1]):
            assert torch.equal(a, b)
        st_k, st_p = out_k[1], out_p[1]


def test_decode_stack_q4_row_tiled_7b_widths(dev):
    """q4 at RWKV-4 7B widths (E = 4096, F = 16384), L = 2, with the row-tiled
    families paired within blocks of 256: the contraction splits run the
    long path, and a split may start inside a pairing block."""
    cfg = RWKVConfig(n_layer=2, n_embd=4096, vocab_size=1000)
    p = params_to(random_quantized_params_np(cfg, seed=23, pad_multiple=128, q4=True,
                                             q4_block=256), dev)
    assert p.att.output.block == 256 and p.ffn.value.block == 256
    rng = np.random.default_rng(23)
    B = 3
    st_k = st_p = init_state(cfg, (B,), device=dev)
    for _ in range(2):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        before = ds_mod.launches_q4
        out_k = ds_mod.decode_stack(p, tok, st_k)
        assert ds_mod.launches_q4 == before + 1
        out_p = ds_mod.decode_stack_plain(p, tok, st_p)
        for a, b in zip(_flat(out_k), _flat(out_p)):
            assert _scaled(a, b) <= 1e-4
        st_k, st_p = out_k[1], out_p[1]


def test_decode_stack_stamps_and_grid(dev, stack_params):
    """The %globaltimer stamps: 4 L + 2 of them, in order; the grid is the
    occupancy API's blocks per SM times the SMs."""
    cfg, params = stack_params
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = ds_mod.stack_grid(1, cfg.n_embd)
    assert grid >= sms and grid % sms == 0
    stamps = torch.zeros(4 * cfg.n_layer + 2, dtype=torch.int64, device=dev)
    tok = torch.tensor([7], device=dev)
    st = init_state(cfg, (1,), device=dev)
    plain = ds_mod.decode_stack(params["q8"], tok, st)
    stamped = ds_mod.decode_stack(params["q8"], tok, st, stamps=stamps)
    for a, b in zip(_flat(plain), _flat(stamped)):
        assert torch.equal(a, b)
    t = stamps.cpu()
    assert bool((t > 0).all()) and bool((t[1:] >= t[:-1]).all())
    with pytest.raises(ValueError, match="stamps"):
        ds_mod.decode_stack(params["q8"], tok, st, stamps=stamps[:3])


@pytest.mark.parametrize("tc", [False, True], ids=["cuda_cores", "tensor_cores"])
@pytest.mark.parametrize("B", [1, 5, 16])
def test_decode_stack_q8_paths_same_bits_and_graph_replay(dev, stack_params, B, tc):
    """Each q8 path, whatever tc_path picks at this B: two launches give the
    same bits, a CUDA graph's replays give the launch's bits, and the tensor-
    core path matches the plain version as the CUDA-core one does."""
    cfg, params = stack_params
    p = params["q8"]
    rng = np.random.default_rng(40 + B)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
    st = init_state(cfg, (B,), device=dev)
    for _ in range(2):  # a state that is not all zeros
        st = ds_mod.decode_stack(p, tok, st, tc=tc)[1]
    before = ds_mod.launches_tc
    eager = ds_mod.decode_stack(p, tok, st, tc=tc)
    assert ds_mod.launches_tc == before + tc
    for a, b in zip(_flat(eager), _flat(ds_mod.decode_stack(p, tok, st, tc=tc))):
        assert torch.equal(a, b)
    for a, b in zip(_flat(eager), _flat(ds_mod.decode_stack_plain(p, tok, st))):
        assert _scaled(a, b) <= 1e-4
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ds_mod.decode_stack(p, tok, st, tc=tc)
    for _ in range(3):  # replays reuse the barrier's and the split-K counters' words
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(_flat(captured), _flat(eager)):
            assert torch.equal(a, b)


def test_decode_stack_tc_14b_widths(dev):
    """q8 at RWKV-4 14B widths (E = 5120, F = 20480), L = 2, B = 16: the
    tensor-core kernel's splits of 640 rows and more over groups of tiles,
    as the 14B cell runs it, against the plain version."""
    cfg = RWKVConfig(n_layer=2, n_embd=5120, vocab_size=1000)
    p = params_to(signedize_params(random_quantized_params_np(cfg, seed=25, pad_multiple=128)),
                  dev)
    B = 16
    assert ds_mod.tc_path(B, cfg.n_embd, cfg.n_ffn, "q8")
    rng = np.random.default_rng(25)
    st_k = st_p = init_state(cfg, (B,), device=dev)
    for _ in range(2):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        before = ds_mod.launches_tc
        out_k = ds_mod.decode_stack(p, tok, st_k)
        assert ds_mod.launches_tc == before + 1
        out_p = ds_mod.decode_stack_plain(p, tok, st_p)
        for a, b in zip(_flat(out_k), _flat(out_p)):
            assert _scaled(a, b) <= 1e-4
        st_k, st_p = out_k[1], out_p[1]


def test_decode_stack_refused_launch_raises(dev, stack_params):
    """A launch the card refuses (here: more shared memory than a block may
    have, for the [3, B] offset terms of a huge batch) raises; no other
    route runs the step."""
    cfg, params = stack_params
    B = 8192
    st = init_state(cfg, (B,), device=dev)
    before = ds_mod.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        ds_mod.decode_stack(params["q8"], torch.zeros(B, dtype=torch.long, device=dev), st)
    assert ds_mod.launches == before


# -- decode and sampling as one device program (runtime/graphs.py) ----------------

GRAPH_BODIES = ("q8", "q4", "a8", "fused", "halves")


@pytest.fixture(scope="module")
def graph_hosts():
    """Host params at E = 256, L = 2, the bundled tokenizer's vocab (padded
    to 50688): q8 and packed q4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = RWKVConfig(n_layer=2, n_embd=256)
    return {"q8": random_quantized_params_np(cfg, seed=21, pad_multiple=512),
            "q4": random_quantized_params_np(cfg, seed=22, pad_multiple=512, q4=True)}


def _graph_engine(body, hosts, dev):
    """An engine on the card decoding through `body`: K1 (q8), K4 (q4), K5
    (a8), or the sharded step on a mesh of the card, "fused" (K7) or
    "halves" (K6)."""
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.runtime.engine import RWKV

    mesh = make_mesh(model=1, devices=[dev]) if body in ("fused", "halves") else None
    eng = RWKV(device=dev, quant="q4" if body == "q4" else "q8", sharding=mesh,
               tp_body=body if mesh else None)
    eng.load_params(hosts["q4" if body == "q4" else "q8"], a8=body == "a8")
    eng.load_tokenizer()
    if mesh is not None:
        assert eng._step_fn.body == body
    return eng


def _stack_counts():
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
    from rwkv_tpu_torch.ops.cuda import tp_halves as th

    return {"q8": ds_mod.launches, "q4": ds_mod.launches_q4, "a8": ds_mod.launches_a8,
            "fused": k7.launches, "halves": th.launches_att + th.launches_ffn}


# (prompt, temp, tau, seed, ban): every setting changes between calls, so a
# value the capture baked into a graph would show in the replays
GRAPH_CALLS = [("Once upon a time", 0.9, 0.8, 1, (0,)),
               ("The capital of France", 0.5, 1.0, 7, (0, 11)),
               ("Once upon a time", 1.2, 0.5, 2, (0,)), ("Hello", 1.0, 0.95, 3, (0, 187, 13))]


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("body", GRAPH_BODIES)
def test_engine_graphed_ids_equal_eager(dev, graph_hosts, body, chunk):
    """RWKV.generate on the card decodes each chunk as one CUDA-graph replay of
    step + ban + typical (after the warm-up call of each chunk length), the
    first id after the prompt as one more: the texts equal the eager path's
    for the same seeds and settings, one replay a chunk, and the stack's
    launch count rises by one step's launches per decoded token."""
    eng = _graph_engine(body, graph_hosts, dev)
    n, L = 21, eng.config.n_layer
    per_step = 4 * L if body == "halves" else 1
    graphed = []
    for i, (prompt, temp, tau, seed, ban) in enumerate(GRAPH_CALLS):
        eng.reset_state()
        eng.load_context(prompt)
        before, replays = _stack_counts()[body], eng._graphs.replays
        graphed.append(eng.generate("", max_tokens=n, temp=temp, tau=tau, seed=seed,
                                    ban_tokens=ban, chunk=chunk))
        torch.cuda.synchronize()
        assert _stack_counts()[body] - before == per_step * (n - 1), (body, i)
        if i:  # every program already captured: one replay a chunk, one for the first id
            assert eng._graphs.replays - replays == -(-(n - 1) // chunk) + 1, (body, i)
    # the first id's program, k = chunk and the tail's
    assert len(eng._graphs) == (2 if chunk == 1 else 3)
    eng._graphs.enabled = False
    for (prompt, temp, tau, seed, ban), want in zip(GRAPH_CALLS, graphed):
        eng.reset_state()
        eng.load_context(prompt)
        assert eng.generate("", max_tokens=n, temp=temp, tau=tau, seed=seed, ban_tokens=ban,
                            chunk=chunk) == want, (body, chunk, prompt)


@pytest.mark.parametrize("step_chunk", [1, 4])
@pytest.mark.parametrize("body", GRAPH_BODIES)
def test_pool_graphed_texts_equal_eager(dev, graph_hosts, body, step_chunk):
    """InferencePool.step on the card replays one CUDA graph per step_chunk
    steps: 7 requests through 3 slots (slot generators reseeded after the
    capture, settings and bans differing per request) give the eager pool's
    texts, and the stack's launches equal step_chunk steps a program."""
    from rwkv_tpu_torch.runtime.pool import InferencePool

    eng = _graph_engine(body, graph_hosts, dev)
    per_step = 4 * eng.config.n_layer if body == "halves" else 1

    def serve(enabled):
        pool = InferencePool(eng.params, eng.tokenizer, max_streams=3, prefill_bucket=32,
                             step_fn=eng._step_fn, prefill_fn=eng._prefill_impl,
                             step_chunk=step_chunk)
        pool._graphs.enabled = enabled
        rids = [pool.submit(p, max_tokens=9 + 2 * i, temp=t, tau=u, seed=s, ban_tokens=b)
                for i, (p, t, u, s, b) in enumerate(GRAPH_CALLS + GRAPH_CALLS[:3])]
        before = _stack_counts()[body]
        out = pool.run()
        torch.cuda.synchronize()
        programs = pool._graphs.replays + len(pool._graphs)
        return [out[r] for r in rids], _stack_counts()[body] - before, programs, pool

    texts, launches, programs, pool = serve(True)
    assert len(pool._graphs) == 1 and pool._graphs.replays == programs - 1 > 0
    assert launches == per_step * step_chunk * programs
    want, _, _, _ = serve(False)
    assert texts == want, (body, step_chunk)


def test_graphs_count_one_capture_a_key(dev):
    """The metrics registry's graphs.captures rises once for each key a
    Graphs captures, however often the key replays, and once more for a key
    captured anew after reset()."""
    from rwkv_tpu_torch.runtime.graphs import Graphs
    from rwkv_tpu_torch.utils.metrics import metrics

    def captures():
        return metrics.snapshot()["counters"].get("graphs.captures", 0)

    graphs = Graphs()
    x = torch.arange(8, dtype=torch.float32, device=dev)
    before = captures()
    for key, k in (("a", 1.0), ("b", 2.0)):
        for _ in range(3):
            out = graphs(key, lambda t, k=k: t * k, x)
    torch.cuda.synchronize()
    assert captures() - before == 2 and len(graphs) == 2 and graphs.replays == 4
    torch.testing.assert_close(out, 2 * x)
    graphs.reset()
    graphs("a", lambda t: t * 1.0, x)
    assert captures() - before == 3


def test_typical_on_the_card_tensor_settings_and_graph(dev):
    """On the card: tensor temp (float64) and tau draw the float path's ids,
    and typical captured with its generator registered, then replayed after
    reseeding, draws what it draws eagerly from that seed."""
    from rwkv_tpu_torch.ops.sampling import typical
    from rwkv_tpu_torch.runtime.graphs import Graphs

    rng = np.random.default_rng(5)
    logits = torch.from_numpy((rng.normal(size=(8, 50688)) * 3).astype(np.float32)).to(dev)
    gens = [torch.Generator(device=dev) for _ in range(8)]
    for temp in (0.5, 0.7, 1.0, 2.0):
        for tau in (0.0, 0.8, 1.0):
            for g, s in zip(gens, range(8)):
                g.manual_seed(s)
            floats = [int(typical(logits[b], gens[b], temp=temp, tau=tau)) for b in range(8)]
            for g, s in zip(gens, range(8)):
                g.manual_seed(s)
            rows = typical(logits, gens, torch.full((8,), temp, dtype=torch.float64, device=dev),
                           torch.full((8,), tau, device=dev)).tolist()
            assert rows == floats, (temp, tau)
    graphs = Graphs(generators=gens)
    temp = torch.full((8,), 0.9, dtype=torch.float64, device=dev)
    tau = torch.full((8,), 0.8, device=dev)
    draw = lambda lg, t, u: typical(lg, gens, t, u)  # noqa: E731
    for seed in (3, 4, 3):
        for i, g in enumerate(gens):
            g.manual_seed(seed * 10 + i)
        got = [graphs(("t",), draw, logits, temp, tau).tolist() for _ in range(3)]
        for i, g in enumerate(gens):
            g.manual_seed(seed * 10 + i)
        assert got == [draw(logits, temp, tau).tolist() for _ in range(3)], seed
        temp = temp * 1.1
    assert len(graphs) == 1 and graphs.replays == 8


@pytest.mark.parametrize("quant", ["q8", "q4"])
def test_bf16_forward_seq_on_the_card_matches_cpu(dev, quant):
    """bf16 prefill on the card (cuBLAS bf16 products with float32 outputs)
    against its plain version on the CPU (the operands widened to float32):
    the same bf16 operands, float32 sums in another order, so within the bf16
    pin of tests/test_torch_prefill.py; the float32 prefill beside it."""
    from rwkv_tpu_torch.models.rwkv4 import forward_seq

    cfg = RWKVConfig(n_layer=2, n_embd=256, vocab_size=1000)
    host = signedize_params(random_quantized_params_np(cfg, seed=5, pad_multiple=128,
                                                       q4=quant == "q4", q4_block=128))
    cpu, gpu = params_to(host, "cpu"), params_to(host, dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 1000, size=(37, 3)))
    lens = torch.tensor([37, 20, 0])
    for dtype in (torch.bfloat16, torch.float32):
        lc, sc = forward_seq(cpu, toks, init_state(cfg, (3,)), parallel=True, length=lens,
                             compute_dtype=dtype)
        lg, sg = forward_seq(gpu, toks.to(dev), init_state(cfg, (3,), device=dev), parallel=True,
                             length=lens.to(dev), compute_dtype=dtype)
        assert lg.dtype == torch.float32 and bool(torch.isfinite(lg).all())
        tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
        assert _scaled(lg.cpu(), lc) <= tol, (dtype, _scaled(lg.cpu(), lc))
        for a, b in zip(sg, sc):
            assert _scaled(a.cpu(), b) <= tol


def test_mock_pooled_server_on_the_card(dev):
    """The --mock server with --pool 2 --bf16-prefill on the card answers 4
    concurrent requests, its decode on kernels K1 and K2 (the launch
    counters advance)."""
    import json
    import threading
    import urllib.request

    from rwkv_tpu_torch.apps.server import make_server

    srv, eng, runner, _ = make_server(["--mock", "--pool", "2", "--pool-chunk", "2",
                                       "--bf16-prefill", "--port", "0"])
    assert eng.device.type == "cuda" and runner.pool.prefill_dtype == torch.bfloat16
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_port}/complete"
    before = (ds_mod.launches, mm8_mod.launches)
    results = {}

    def hit(i):
        req = urllib.request.Request(url, json.dumps({"prompt": f"Request {i} " * (i + 1),
                                                      "max_tokens": 6, "seed": i}).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            results[i] = (r.status, json.loads(r.read()))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.shutdown()
        srv.server_close()
        assert runner.drain(timeout=60)
    assert sorted(results) == [0, 1, 2, 3]
    assert all(code == 200 and body["tokens"] >= 1 for code, body in results.values())
    assert ds_mod.launches > before[0] and mm8_mod.launches > before[1]


def test_torch_rwkv_on_the_card_matches_plain(dev):
    """TorchRWKV on the card: each forward one launch of K1 and one of K2,
    the logits against the plain model on the loaded weights; the state
    passed in left as it was; forward_batch rows equal to single streams."""
    from rwkv_tpu_torch.interop.torch import TorchRWKV

    cfg = RWKVConfig(n_layer=2, n_embd=256, vocab_size=1000)
    w = TorchRWKV(params=random_quantized_params_np(cfg, seed=8, pad_multiple=None))
    assert w.device.type == "cuda"
    params = w._eng.params
    state = w.empty_state()
    for tok in (5, 999, 0, 17):
        kept = [s.clone() for s in state]
        before = (ds_mod.launches, mm8_mod.launches)
        logits, new = w.forward(tok, state)
        assert (ds_mod.launches, mm8_mod.launches) == (before[0] + 1, before[1] + 1)
        ref, ref_state = forward_step(params, torch.tensor(tok, device=dev), WKVState(*state))
        assert logits.shape == (1024,) and logits.device.type == "cuda"
        assert _scaled(logits, ref[:1024]) <= 1e-4
        for a, b in zip(new, ref_state):
            assert _scaled(a, b) <= 1e-4
        assert all(torch.equal(a, b) for a, b in zip(state, kept))
        state = new
    toks = torch.tensor([3, 500, 999])
    batch = [torch.stack([s] * 3, dim=1) for s in state]
    lb, sb = w.forward_batch(toks, batch)
    for b in range(3):
        lr, sr = w.forward(int(toks[b]), state)
        assert _scaled(lb[b], lr) <= 1e-4
        for a, c in zip(sb, sr):
            assert _scaled(a[:, b], c) <= 1e-4


def test_sample_logits_on_the_card(dev):
    """sample_logits on the card: the kept set of its CPU plain computation
    on the same logits, the same draws from the same seed, every draw kept."""
    from rwkv_tpu_torch.ops.sampling import nucleus_logits, sample_logits

    rng = np.random.default_rng(6)
    host = torch.from_numpy((rng.normal(size=(8, 50688)) * 3).astype(np.float32))
    logits = host.to(dev)
    for temp, top_p in ((0.7, 0.9), (1.0, 0.5), (2.0, 1.0)):
        kept = torch.isfinite(nucleus_logits(logits, temp=temp, top_p=top_p)).cpu()
        assert torch.equal(kept, torch.isfinite(nucleus_logits(host, temp=temp, top_p=top_p)))
        draws = [sample_logits(logits, torch.Generator(device=dev).manual_seed(9),
                               temp=temp, top_p=top_p).cpu() for _ in range(2)]
        assert torch.equal(draws[0], draws[1])
        assert bool(kept[torch.arange(8), draws[0]].all())


def test_native_tokenizer_builds_on_the_card_machine(dev, tmp_path, monkeypatch):
    """The C++ tokenizer compiles on the GPU machine and matches the Python
    one: README.md's ids, the added tokens' bytes."""
    import os

    from rwkv_tpu_torch.tokenizer import assets, native
    from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    tok = native.NativeBPETokenizer.load(assets.ensure_files(str(tmp_path / "vocab")))
    py = BPETokenizer.load()
    readme = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "README.md")
    with open(readme, encoding="utf-8") as f:
        text = f.read()
    assert tok.encode(text) == py.encode(text)
    assert [tok.decode_bytes([i]) for i in range(50254, 50277)] == \
        [py.decode_bytes([i]) for i in range(50254, 50277)]


# -- across cards: kernel K7 with each shard on its own card (needs >= 2 cards) ----------


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices (K7 across cards)")
    return [torch.device("cuda", i) for i in range(min(4, torch.cuda.device_count()))]


@pytest.mark.parametrize("quant", ["q8", "q4"])
@pytest.mark.parametrize("B", [1, 3, 8, 11])
def test_decode_stack_tp_across_cards_matches_plain(cards, quant, B):
    """K7 over a row of distinct cards (one launch per card, the exchanges
    peer stores), q8 and q4, the embedding gather in the step (B <= 8) or an
    x given (B > 8), against its plain version on copies of the shards on
    card 0, over 2 carried steps."""
    from rwkv_tpu_torch.models.rwkv4 import q4_pack_block
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
    from rwkv_tpu_torch.ops.layernorm import layer_norm
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import shard_params, shard_state

    tp = len(cards)
    cfg = RWKVConfig(n_layer=2, n_embd=128 * tp, vocab_size=1000)
    host = random_quantized_params_np(cfg, seed=11, pad_multiple=128 * tp, q4=quant == "q4",
                                      q4_block=q4_pack_block(cfg.n_embd, tp))
    params = params_to(signedize_params(host) if quant == "q8" else host, "cpu")
    sp = shard_params(params, make_mesh(model=tp, devices=cards))
    dev0 = cards[0]
    ref = [params_to(p, dev0) for p in sp.rows[0]]
    local = [sp.local(0, j) for j in range(tp)]
    local_ref = [(d.to(dev0), b.to(dev0)) for d, b in local]
    st_k = shard_state(init_state(cfg, (B,), device=dev0), sp.mesh)[0]
    st_p = [WKVState(*(t.to(dev0) for t in c)) for c in st_k]
    rng = np.random.default_rng(B)
    for _ in range(2):
        tok = torch.from_numpy(rng.integers(0, 1000, size=(B,))).to(dev0)
        if B <= k7.FUSE_EMBED_MAX_B:
            kw = {"token": tok}
        else:
            p0 = params_to(params, dev0)
            kw = {"x": layer_norm(p0.emb[tok], p0.ln0.weight, p0.ln0.bias)}
        before = k7.launches + k7.launches_q4
        lg_k, n_k = k7.decode_stack_tp(sp.rows[0], st_k, local, **kw)
        assert k7.launches + k7.launches_q4 == before + tp
        lg_p, n_p = k7.decode_stack_tp_reference(ref, st_p, local_ref, **kw)
        for j in range(tp):
            assert lg_k[j].device == cards[j]
            assert _scaled(lg_k[j].to(dev0), lg_p[j]) <= 1e-4
            for a, b in zip(n_k[j], n_p[j]):
                assert a.device == cards[j] and _scaled(a.to(dev0), b) <= 1e-4
        st_k, st_p = n_k, n_p


def test_engine_across_cards_matches_one_card(cards, tmp_path):
    """RWKV(path, sharding=make_mesh(model=tp)) over distinct cards runs the
    fused body (K7 across cards, tp launches a step), from CUDA graphs across
    the cards (the step's own for forward, the decode programs'), its state
    resident per card (no whole-state cut or join while decoding), its
    logits within 3e-4 of the one-card engine's."""
    from rwkv_tpu_torch.io.binfmt import write_bin
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
    from rwkv_tpu_torch.parallel import sharding
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.runtime.engine import RWKV

    tp = len(cards)
    path = str(tmp_path / "m.bin")
    write_bin(path, random_quantized_params_np(RWKVConfig(n_layer=2, n_embd=256 * tp), seed=5,
                                               pad_multiple=None))
    one = RWKV(path, device=cards[0])
    eng = RWKV(path, sharding=make_mesh(model=tp, devices=cards))
    assert eng._step_fn.body == "fused" and eng._graphs.enabled and eng._step_fn.graphed
    assert isinstance(eng._state, sharding.ShardedState)
    V = eng._true_vocab
    a, b = one.forward([3, 4, 5]), eng.forward([3, 4, 5])
    assert _scaled(b[:V], a[:V]) <= 3e-4
    cuts = dict(sharding.counts)
    before = k7.launches
    for _ in range(6):
        t = int(a.argmax())
        a, b = one.forward(t), eng.forward(t)
        assert _scaled(b[:V], a[:V]) <= 3e-4
    assert sharding.counts == cuts and k7.launches == before + 6 * tp
    assert eng._step_fn.graphs.replays >= 5


def test_wrappers_launch_on_their_tensors_card_across_cards(cards):
    """K2 (mm8) and K6 (att_half, ffn_half) given tensors on card 1 while
    card 0 is current launch on card 1 (a launch on the current device ran
    every shard of a mesh over cards on card 0, its weights read over
    NVLink), and give card 0's bits for the same inputs there."""
    from torch.profiler import ProfilerActivity, profile

    from rwkv_tpu_torch.ops.cuda import tp_halves as th

    one = cards[1]
    cfg = RWKVConfig(n_layer=1, n_embd=256, vocab_size=1000)
    host = signedize_params(random_quantized_params_np(cfg, seed=9, pad_multiple=128))
    p0, p1 = params_to(host, cards[0]), params_to(host, one)
    rng = np.random.default_rng(9)
    x, xy, dd, aa, bb, pp = (torch.from_numpy(rng.normal(size=(2, 256)).astype(np.float32))
                             for _ in range(6))

    def run(p, d):
        t = [v.to(d) for v in (x, xy, dd, aa, bb, pp)]
        return (th.att_half(p, 0, t[0], t[1], t[3], t[4], t[5], p.att.decay, p.att.bonus)
                + th.ffn_half(p, 0, t[0], t[2])
                + (mm8_mod.mm8(t[0], p.head.w),))

    torch.cuda.set_device(cards[0])
    want = run(p0, cards[0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = run(p1, one)
        torch.cuda.synchronize(one)
    ran = {e.device_index for e in prof.events()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
           and "rwkv::" in e.name}
    assert ran == {one.index}
    for a, b in zip(got, want):
        assert a.device == one and torch.equal(a.to(cards[0]), b)


def test_int8_heads_launch_on_their_tensors_card(cards):
    """K2 and K5's head given tensors on card 1 while card 0 is current
    launch on card 1 (fault 7's pin), and give card 0's bits there."""
    from torch.profiler import ProfilerActivity, profile

    one = cards[1]
    host = _head_operands(torch.device("cpu"), 8, 1024, 50688, 77)

    def run(d):
        xs, w, col = (t.to(d) for t in host)
        return (mm8_mod.mm8(xs, w, col_add=col), *mm8_mod.mm8_a8(xs, w, col_add=col,
                                                                  return_codes=True))

    torch.cuda.set_device(cards[0])
    want = run(cards[0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = run(one)
        torch.cuda.synchronize(one)
    ran = {e.device_index for e in prof.events()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
           and "int8_head_kernel" in e.name}
    assert ran == {one.index}
    for a, b in zip(got, want):
        assert a.device == one and torch.equal(a.to(cards[0]), b)


@pytest.fixture(scope="module")
def cards_sp(cards):
    """Signed q8 params at E = 256 a card (every body eligible), L = 2,
    sharded over the cards."""
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.parallel.sharding import shard_params, tp_vocab_multiple

    tp = len(cards)
    cfg = RWKVConfig(n_layer=2, n_embd=256 * tp, vocab_size=1000)
    host = signedize_params(random_quantized_params_np(cfg, seed=21,
                                                       pad_multiple=tp_vocab_multiple(tp)))
    return cfg, shard_params(params_to(host, "cpu"), make_mesh(model=tp, devices=cards))


def _sync(cards):
    for c in cards:
        torch.cuda.synchronize(c)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("body", ["fused", "halves", "plain"])
def test_tp_step_across_cards_graph_equals_eager(cards, cards_sp, body, B):
    """The step over distinct cards of one process is one CUDA graph across
    them (each card's K7, or K6 + K2, or plain ops, and the NCCL
    collectives): from its second call each call is one replay, bit-equal to
    the eager body over 4 carried steps (logits and every card's resident
    state), and each call advances the launch counters and the mesh's
    collective counts by one step's worth."""
    from rwkv_tpu_torch.parallel.sharding import ShardedState
    from rwkv_tpu_torch.parallel.tp_step import make_tp_step
    from rwkv_tpu_torch.runtime import graphs

    cfg, sp = cards_sp
    mesh, tp, L = sp.mesh, len(cards), cfg.n_layer
    step = make_tp_step(mesh, sp, body=body)
    assert step.body == body and step.graphed
    want = {"fused": {"decode_stack_tp.launches": tp},
            "halves": {"tp_halves.launches_att": 2 * L * tp,
                       "tp_halves.launches_ffn": 2 * L * tp, "mm8.launches": tp},
            "plain": {}}[body]
    coll = ({"psum": 0, "all_gather": 1} if body == "fused"
            else {"psum": 2 * L + 1, "all_gather": L + 1})
    names = [f"{m.__name__.rsplit('.', 1)[1]}.{a}" for m, a in graphs.COUNTERS]
    st = ShardedState.zeros(cfg, B, mesh)
    st_e = st.with_leaves([t.clone() for t in st])
    rng = np.random.default_rng(B)
    for i in range(4):
        tok = torch.from_numpy(rng.integers(0, 1000, size=(B,))).to(cards[0])
        before, replays = graphs.counts(mesh), step.graphs.replays
        logits, st = step(sp, tok, st)
        delta = [a - b for a, b in zip(graphs.counts(mesh), before)]
        assert {n: d for n, d in zip(names, delta) if d} == want, (body, B, i)
        assert dict(zip(mesh.collectives, delta[len(names):])) == coll, (body, B, i)
        assert step.graphs.replays - replays == (1 if i else 0)
        ref, st_e = step.eager(sp, tok, st_e)
        _sync(cards)
        assert torch.equal(logits, ref), (body, B, i, _scaled(logits, ref))
        for a, b in zip(st, st_e):
            assert a.device == b.device and torch.equal(a, b), (body, B, i, _scaled(a, b))
    assert len(step.graphs) == 1


@pytest.mark.parametrize("body", ["fused", "halves"])
def test_tp_step_across_cards_replay_waits_for_a_write_on_card_1(cards, cards_sp, body):
    """The caller writes card 1's resident state on card 1's current stream,
    behind a spin of tens of milliseconds, and replays at once: the replay
    waits for that stream (it reads the written state, as the eager body
    does), and the logits read on card 0 and the state read on card 1 come
    after it."""
    from rwkv_tpu_torch.parallel.sharding import ShardedState
    from rwkv_tpu_torch.parallel.tp_step import make_tp_step

    cfg, sp = cards_sp
    step = make_tp_step(sp.mesh, sp, body=body)
    st = ShardedState.zeros(cfg, 2, sp.mesh)
    tok = torch.tensor([5, 900], device=cards[0])
    for _ in range(3):
        _, st = step(sp, tok, st)
    assert step.graphs.replays == 2
    rng = np.random.default_rng(7)
    for r in range(3):
        cell = st.cells[0][1]
        new = [torch.from_numpy(rng.normal(size=tuple(t.shape)).astype(np.float32)).to(cards[1])
               for t in cell]
        _sync(cards)
        with torch.cuda.device(cards[1]):
            torch.cuda._sleep(50_000_000)
            for t, v in zip(cell, new):
                t.copy_(v)
        logits, got = step(sp, tok, st)
        on1 = [t.clone() for t in got.cells[0][1]]  # read on card 1's current stream
        st_e = st.with_leaves([t.clone() for t in st])
        ref, want = step.eager(sp, tok, st_e)
        _sync(cards)
        assert torch.equal(logits, ref), (body, r)
        for a, b in zip(on1, want.cells[0][1]):
            assert torch.equal(a, b), (body, r)
        st = got
    assert step.graphs.replays == 5


def test_engine_and_pool_across_cards_graphed_equal_eager(cards, tmp_path):
    """The engine over distinct cards decodes each chunk as one replay of a
    graph across the cards (K7 on every card, the logits gather, ban +
    typical on card 0): greedy texts at tau = 0 equal the eager engine's
    (its programs and the step's own graph off), and the pool's texts
    graphed equal its eager texts and the engine's."""
    from rwkv_tpu_torch.io.binfmt import write_bin
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp as k7
    from rwkv_tpu_torch.parallel.mesh import make_mesh
    from rwkv_tpu_torch.runtime.engine import RWKV
    from rwkv_tpu_torch.runtime.pool import InferencePool

    tp = len(cards)
    path = str(tmp_path / "m.bin")
    write_bin(path, random_quantized_params_np(RWKVConfig(n_layer=2, n_embd=256 * tp), seed=8,
                                               pad_multiple=None))
    eng = RWKV(path, sharding=make_mesh(model=tp, devices=cards))
    eng.load_tokenizer(native=False)
    calls = [("Once upon a time", 1.0, 0.0, 1, 1), ("The capital of France", 0.7, 0.0, 2, 8),
             ("Hello", 1.3, 0.0, 3, 8)]

    def texts():
        out = []
        for prompt, temp, tau, seed, chunk in calls:
            eng.reset_state()
            out.append(eng.generate(prompt, max_tokens=17, temp=temp, tau=tau, seed=seed,
                                    chunk=chunk))
        return out

    before = k7.launches
    graphed = texts()
    assert eng._graphs.replays > 0 and len(eng._graphs) >= 3
    assert k7.launches > before
    eng._graphs.enabled = eng._step_fn.graphs.enabled = False
    assert texts() == graphed
    eng._graphs.enabled = eng._step_fn.graphs.enabled = True

    def serve(enabled):
        pool = InferencePool(eng.params, eng.tokenizer, max_streams=3, prefill_bucket=32,
                             step_fn=eng._step_fn, prefill_fn=eng._prefill_impl)
        pool._graphs.enabled = eng._step_fn.graphs.enabled = enabled
        rids = [pool.submit(p, max_tokens=9 + i, temp=t, tau=0.0, seed=s)
                for i, (p, t, _, s, _) in enumerate(calls + calls[:2])]
        out = pool.run()
        eng._step_fn.graphs.enabled = True
        return [out[r] for r in rids], pool

    pooled, pool = serve(True)
    assert len(pool._graphs) == 1 and pool._graphs.replays > 0
    assert serve(False)[0] == pooled
    for (p, t, _, s, _), i, text in zip(calls + calls[:2], range(5), pooled):
        eng.reset_state()
        assert eng.generate(p, max_tokens=9 + i, temp=t, tau=0.0, seed=s) == text


# -- across processes: kernel K7 with one card a process (needs >= 2 cards) ------------


def _pod_job(n, args_of, tmp, timeout=600):
    """n pod_worker processes (rwkv_tpu_torch/tools/pod_worker.py) on one job;
    each one's JSON record."""
    import json
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rwkv_tpu_torch.tools.pod_worker", "--coordinator",
         f"127.0.0.1:{port}", "--processes", str(n), "--process-id", str(i), *args_of(i)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    recs = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"POD_WORKER_OK {i}" in out, out[-4000:]
        recs.append(json.loads(next(ln for ln in out.splitlines() if ln.startswith("{"))))
    return recs


@pytest.fixture(scope="module", params=["q8", "q4"])
def k7_pair(request, tmp_path_factory):
    """Two processes of one card each, pod_mesh(model=2) on NCCL, the fused
    body (K7 across processes, graphed; q8, and q4 with its row-tiled blocks
    inside a shard) against the unsharded step (K1 + K2, or K4, on card 0)
    and K7 against its plain version: each process's record."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices (K7 across processes)")
    from rwkv_tpu_torch.parallel.sharding import tp_vocab_multiple
    from rwkv_tpu_torch.tools import pod_worker

    tmp = tmp_path_factory.mktemp(f"k7_pair_{request.param}")
    spec = "random:2x256:1" + (":q4" if request.param == "q4" else "")
    whole = params_to(pod_worker.random_params(spec, tp_vocab_multiple(2), 2), "cuda:0")
    refs = []
    for B, tokens in ((3, (5, 700, 50000)), (8, tuple(range(11, 8 * 997, 997)))):
        refs.append(str(tmp / f"ref{B}.npz"))
        pod_worker.write_reference(whole, refs[-1], torch.device("cuda", 0), tokens=tokens)
    del whole
    torch.cuda.empty_cache()
    return _pod_job(2, lambda i: [
        "--params", spec, "--ref", *refs, "--backend", "nccl", "--devices", f"cuda:{i}",
        "--model", "2", "--bodies", "fused", "--k7-check"], tmp)


def test_decode_stack_tp_across_processes_matches_plain(k7_pair):
    """K7 across two processes, one card each, B = 3 and 8: logits and states
    within 1e-4 of its plain version (the exchanges over the row's NCCL
    group), one launch a step in each process, and the fused step within
    the TP pin of the unsharded step."""
    for rec in k7_pair:
        assert rec["group"] == {"backend": "nccl", "ranks": [0, 1]}
        for k in rec["k7"]:
            assert k["max_scaled_err"] <= 1e-4 and k["launches"] == 2, k
        for key, body in rec["bodies"].items():
            assert body["max_scaled_err"] <= 3e-4, key
            k7_launches = {k: v for k, v in body["launches"].items() if v}
            assert k7_launches in ({"decode_stack_tp.launches": body["steps"] + 3},
                                   {"decode_stack_tp.launches_q4": body["steps"] + 3}), key


def test_decode_stack_tp_across_processes_graph_replays_flags(k7_pair):
    """The fused step across processes is one CUDA graph a process: after N
    steps (the warm-up, then replays) the card's step counter is N, every
    shard's embedding flag N and its att and ffn flags N * L: no epoch was
    frozen into the graph."""
    for rec in k7_pair:
        for key, body in rec["bodies"].items():
            n = body["steps"] + 3
            assert body["graphed"] and body["replays"] == n - 1, key
            assert body["flags"] == [n, n, n, 2 * n, 2 * n, 2 * n, 2 * n], key


def test_decode_stack_tp_across_processes_ipc_teardown_leaves_no_open_handle(k7_pair):
    """Each process opened its peer's region once per batch size, and
    multihost.shutdown closed them all before the regions were freed."""
    for rec in k7_pair:
        assert rec["open_handles"] == 2 and rec["open_handles_after"] == 0


def test_decode_stack_tp_refuses_processes_sharing_a_card(tmp_path):
    """Two processes on one card, pod_mesh(model=2) on gloo: the fused body
    raises, naming the shared card; the halves body runs eagerly within the
    TP pin of the unsharded step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rwkv_tpu_torch.parallel.sharding import tp_vocab_multiple
    from rwkv_tpu_torch.tools import pod_worker

    spec = "random:2x256:2"
    whole = params_to(pod_worker.random_params(spec, tp_vocab_multiple(2), 2), "cuda:0")
    pod_worker.write_reference(whole, str(tmp_path / "ref.npz"), torch.device("cuda", 0))
    del whole
    recs = _pod_job(2, lambda i: [
        "--params", spec, "--ref", str(tmp_path / "ref.npz"), "--backend", "gloo",
        "--devices", "cuda:0", "--model", "2", "--bodies", "halves",
        "--expect-refused", "fused"], tmp_path)
    for rec in recs:
        assert "share one card" in rec["refused"]["fused"]
        halves = rec["bodies"]["halves"]
        assert not halves["graphed"] and halves["max_scaled_err"] <= 3e-4
        assert halves["collectives"] == {"psum": 5 * halves["steps"],
                                         "all_gather": 3 * halves["steps"]}
