"""Kernel K3's arithmetic (csrc/mm4.cu), emulated in plain PyTorch on the CPU,
where the kernel itself cannot run: the nibbles widened to bf16 integers by
the kernel's bit operations, the k order that ldmatrix.trans gives the A
fragments, the activations split into three bf16 pieces and staged by the
kernel's index formula as wgmma's B operand (8 x 16-byte core matrices, the
K-adjacent ones 128 bytes apart, the N-adjacent ones 256), f32 sums one k16
step after another,
and the epilogue's fixed-order sum of a row's three columns. Held against
mm4_plain at the card tests' 1e-5 scaled, and against the JAX package's f32
q4matmul at tests/test_torch_q4.py's 2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.ops import quant as j_quant
from rwkv_tpu_torch.ops.cuda.mm4 import block_half, mm4_plain


def _widen(R: np.ndarray):
    """csrc/mm4.cu widen(): the four A registers of a 32-bit word, each as
    (low half, high half) floats."""
    R = R.astype(np.uint32)
    Rs = R >> np.uint32(4)
    out = []
    for i in range(4):
        ri = (R >> np.uint32(8 * i)) & np.uint32(0xFF)
        si = (Rs >> np.uint32(8 * i)) & np.uint32(0xFF)
        v = ri | (ri << np.uint32(8)) | (si << np.uint32(16)) | (si << np.uint32(24))  # prmt
        v = (v & np.uint32(0x000F000F)) ^ np.uint32(0x43084300)  # lop3 0x6A
        halves = []
        for bits in (v & np.uint32(0xFFFF), v >> np.uint32(16)):
            f = (bits << np.uint32(16)).view(np.float32)  # bf16 -> f32
            halves.append(f - np.float32(136.0))  # fma.rn.bf16x2 v * 1 - 136, exact
        out.append(halves)
    return out


def _a_steps(wp: np.ndarray) -> torch.Tensor:
    """The A operand, [Q, 16, O] f32: k16 step q covers packed rows 8q..8q+7
    (rows past K / 2 zero bytes, as the TMA fills them), in the k order of
    ldmatrix.trans: a thread's word holds rows 2t, 2t + 1 of columns 2g,
    2g + 1, and byte i widens to register i of m16n8k16."""
    J, O = wp.shape
    Q = -(-J // 8)
    b = np.zeros((Q * 8, O), np.uint8)
    b[:J] = wp.view(np.uint8)
    b = b.reshape(Q, 4, 2, O // 2, 2)  # [q, t, row 2t + r, g, column 2g + c]
    word = (b[:, :, 0, :, 0].astype(np.uint32) | (b[:, :, 0, :, 1].astype(np.uint32) << 8)
            | (b[:, :, 1, :, 0].astype(np.uint32) << 16)
            | (b[:, :, 1, :, 1].astype(np.uint32) << 24))  # [q, t, g]
    regs = _widen(word)  # register i: (k 2t, 2t + 1) or (2t + 8, 2t + 9) of row g or g + 8
    A = np.zeros((Q, 16, O // 2, 2), np.float32)  # [q, k, g, column 2g + c]
    for i, (lo, hi) in enumerate(regs):
        k0 = 8 * (i >> 1)  # registers 2, 3 hold k + 8
        col = i & 1  # registers 1, 3: row g + 8, column 2g + 1
        for t in range(4):
            A[:, k0 + 2 * t, :, col] = lo[:, t]
            A[:, k0 + 2 * t + 1, :, col] = hi[:, t]
    return torch.from_numpy(A.reshape(Q, 16, O))


def _stage(xs: np.ndarray, half: int, rows: int, NT: int) -> np.ndarray:
    """stage_pieces(): the uint32 words of the B operand for batch rows `xs`
    (one pass) and packed rows [0, rows), by the kernel's formula."""
    B, K = xs.shape
    J, N = K // 2, 8 * NT
    words = np.zeros(rows * 8 * NT, np.uint32)
    for b in range(-(-N // 3)):
        for jl in range(rows):
            x = np.zeros(2, np.float32)
            if b < B and jl < J:
                lo_row = (jl // half) * 2 * half + jl % half
                x[:] = xs[b, lo_row], xs[b, lo_row + half]
            t32 = torch.from_numpy(x)
            hi = t32.to(torch.bfloat16)
            r1 = t32 - hi.float()
            mid = r1.to(torch.bfloat16)
            lo = (r1 - mid.float()).to(torch.bfloat16)
            q, t, second = jl >> 3, (jl & 7) >> 1, jl & 1
            for p, piece in enumerate((hi, mid, lo)):
                n = 3 * b + p
                if n < N:
                    u = piece.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32)
                    words[q * NT * 64 + ((n >> 3) * 2 + second) * 32 + (n & 7) * 4 + t] = (
                        u[0] | (u[1] << np.uint32(16)))
    return words


def _b_steps(words: np.ndarray, Q: int, NT: int) -> torch.Tensor:
    """The B operand, [Q, 16, N] f32, read back as wgmma reads it: step q's
    core matrix (n-tile, k half) holds columns 8 * ntile + 0..7 (16-byte rows)
    at k = 8 * khalf + 0..7 (2 bytes each)."""
    w = words.reshape(Q, NT, 2, 8, 4)  # [q, ntile, khalf, n % 8, k % 8 // 2]
    bits = np.stack([w & np.uint32(0xFFFF), w >> np.uint32(16)], -1)  # [..., k % 2]
    f = (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)
    Bm = f.transpose(0, 2, 4, 5, 1, 3)  # [q, khalf, k % 8 // 2, k % 2, ntile, n % 8]
    return torch.from_numpy(np.ascontiguousarray(Bm).reshape(Q, 16, 8 * NT))


def mm4_emulated(xs: torch.Tensor, wp: torch.Tensor, *, block=None, row_add=None,
                 col_add=None) -> torch.Tensor:
    B, K = xs.shape
    J, O = wp.shape
    half = block_half(block, K)
    NT = -(-3 * min(B, 16) // 8)
    G = min(16, 8 * NT // 3)
    A = _a_steps(wp.numpy())
    Q = A.shape[0]
    out = torch.empty(B, O)
    for b0 in range(0, B, G):
        rows = xs[b0:b0 + G].numpy()
        Bm = _b_steps(_stage(rows, half, 8 * Q, NT), Q, NT)
        acc = torch.zeros(O, 8 * NT)
        for q in range(Q):  # f32 sums, one k16 step after another
            acc = acc + A[q].T @ Bm[q]
        for b in range(rows.shape[0]):
            v = (acc[:, 3 * b + 2] + acc[:, 3 * b + 1]) + acc[:, 3 * b]
            if row_add is not None:
                v = v + row_add[b0 + b]
            if col_add is not None:
                v = v + col_add
            out[b0 + b] = v
    return out


def _scaled(a, b):
    return float((a.double() - b.double()).abs().max() / max(1.0, float(b.abs().max())))


def _wide(rng, B, K):
    x = rng.choice([-1.0, 1.0], size=(B, K)) * 10.0 ** rng.uniform(-20, 20, size=(B, K))
    x[rng.random(size=(B, K)) < 0.1] = 0.0
    return x.astype(np.float32)


def test_widen_gives_every_nibble_pair():
    codes = np.arange(256, dtype=np.uint32)
    (lo, hi), *_ = _widen(codes)
    signed = codes.astype(np.uint8).view(np.int8).astype(np.int32)
    np.testing.assert_array_equal(lo, (signed & 0xF) - 8)
    np.testing.assert_array_equal(hi, signed >> 4)


@pytest.mark.parametrize("block", [None, 2, 64])
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("wide", [False, True])
def test_emulated_kernel_matches_plain(B, block, wide):
    rng = np.random.default_rng(B * 11 + (block or 0) + wide)
    # K = 200: 100 packed rows, the last k16 step half past the end, zero-filled
    K, O = (192 if block == 64 else 200), 48
    x = _wide(rng, B, K) if wide else (rng.normal(size=(B, K)) / 100).astype(np.float32)
    xs = torch.from_numpy(x)
    wp = torch.from_numpy(rng.integers(-128, 128, size=(K // 2, O), dtype=np.int8))
    row = torch.from_numpy(rng.normal(size=B).astype(np.float32))
    col = torch.from_numpy(rng.normal(size=O).astype(np.float32))
    got = mm4_emulated(xs, wp, block=block, row_add=row, col_add=col)
    ref = mm4_plain(xs, wp, block=block, row_add=row, col_add=col)
    assert bool(torch.isfinite(got).all())
    assert _scaled(got, ref) <= 1e-5


def test_emulated_kernel_passes_past_sixteen_rows():
    rng = np.random.default_rng(17)
    xs = torch.from_numpy(rng.normal(size=(17, 64)).astype(np.float32))
    wp = torch.from_numpy(rng.integers(-128, 128, size=(32, 16), dtype=np.int8))
    assert _scaled(mm4_emulated(xs, wp), mm4_plain(xs, wp)) <= 1e-5


@pytest.mark.parametrize("block", [None, 64])
def test_emulated_kernel_matches_jax_q4matmul_f32(block):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(256, 160)).astype(np.float32)
    x = rng.normal(size=(4, 256)).astype(np.float32)
    jq = j_quant.quantize4(w, block=block)
    ref = np.asarray(j_quant.q4matmul(jnp.asarray(x), jq, variant="unpack"))
    xs = torch.from_numpy((x * np.asarray(jq.scale)).astype(np.float32))
    off = torch.from_numpy((x @ np.asarray(jq.offset)).astype(np.float32))
    got = mm4_emulated(xs, torch.from_numpy(np.array(jq.wp)), block=block, row_add=off)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
