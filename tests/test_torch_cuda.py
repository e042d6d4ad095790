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


@pytest.mark.parametrize("B,K,O", [(1, 64, 16), (3, 1000, 144), (8, 1536, 1040),
                                   (11, 4096, 256), (2, 1024, 50688)])
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
    # deterministic: the split-K partials are summed in a fixed order
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


@pytest.mark.parametrize("B", [1, 3, 9])
def test_decode_stack_matches_plain(dev, small, B):
    cfg, p = small
    rng = np.random.default_rng(B)
    st_k = st_p = init_state(cfg, (B,), device=dev)
    for _ in range(3):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,))).to(dev)
        before = ds_mod.launches
        out_k = ds_mod.decode_stack(p, tok, st_k)
        assert ds_mod.launches == before + 6 * cfg.n_layer + 1
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
                                         (5, 4096, 1024, 2), (2, 1024, 50688, None)])
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
    # deterministic: the split-K partials are summed in a fixed order
    assert torch.equal(mm4_mod.mm4(xs, wp, block=block, row_add=row, col_add=col), got)


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
        assert (ds_mod.launches, ds_mod.launches_q4) == (before[0],
                                                         before[1] + 6 * cfg.n_layer + 1)
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
    assert [a - b for a, b in zip(after, before)] == [6 * cfg.n_layer + 1, 1, 0, 0]
    ref, ref_state = forward_step(p, tok, st)
    assert logits.shape == (2, p.head.wp.shape[1])
    assert _scaled(logits[:, :cfg.vocab_size], ref[:, :cfg.vocab_size]) <= 1e-4
    for a, b in zip(new, ref_state):
        assert _scaled(a, b) <= 1e-4
