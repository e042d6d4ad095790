"""The int8 heads' arithmetic (csrc/int8_head.cuh: kernel K2 in csrc/mm8.cu,
K5's head in csrc/mm8_a8.cu), emulated in plain numpy and PyTorch on the
CPU, where the kernels cannot run: the words ldmatrix.trans gives each
thread, the bit operations that make them A registers (K2: each byte widened
to an exact bf16 integer; K5: bytes permuted into s8 fragments), placed as
the PTX fragment layouts place them (k order and columns), the activations
staged by the kernels' index formulas (K2: three bf16 pieces a value; K5:
int8 codes quantized in the block) and read back as wgmma reads its B
operand (8 x 16-byte core matrices, the K-adjacent ones 128 bytes apart, the
N-adjacent ones 256), the sums one step after another, chunk after chunk,
pass after pass, and the epilogues.

K2 is held against mm8_plain at the card tests' 1e-5 scaled and against the
JAX package's mm8 (Pallas, interpret mode) at tests/test_torch_decode.py's
1e-5; K5's head must be bit-equal to mm8_a8_plain, its codes equal to
quant_rows, and within tests/test_torch_a8.py's 1e-6 scaled of the JAX
mm8_a8 (interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.ops import quant as j_quant
from rwkv_tpu.ops.pallas import mm8 as j_mm8
from rwkv_tpu_torch.ops.cuda.mm8 import mm8_a8_plain, mm8_plain, quant_rows

ROWS = 64  # weight rows a stage of the ring
STAGED_BYTES = 96 * 1024


def _u32(x):
    return np.asarray(x, dtype=np.uint32)


def _prmt(x, y, sel: int):
    """__byte_perm(x, y, sel): byte i of the result is byte (sel >> 4i) & 7
    of the eight bytes of x (0-3) and y (4-7)."""
    src = [(_u32(x) >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    src += [(_u32(y) >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros(np.broadcast(_u32(x), _u32(y)).shape, np.uint32)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def _f32(bits):
    return _u32(bits).view(np.float32)


def _bits(f):
    return np.asarray(f, dtype=np.float32).view(np.uint32)


def widen8(W):
    """int8_head.cuh widen8(): one ldmatrix word -> two bf16x2 registers."""
    X = _u32(W) ^ np.uint32(0x80808080)
    f = [_bits(_f32(_prmt(X, 0x4B000000, 0x7440 | i)) - np.float32(8388736.0)) for i in range(4)]
    return _prmt(f[0], f[2], 0x7632), _prmt(f[1], f[3], 0x7632)


def _halves(r):
    """A bf16x2 register's (low, high) halves as floats."""
    r = _u32(r)
    return _f32(r << np.uint32(16)), _f32(r & np.uint32(0xFFFF0000))


def _words(Wp: np.ndarray, R: int, j: int):
    """The ldmatrix.trans words of rows R + 8j .. R + 8j + 7, [t, G]: thread
    (g, t) of column chunk G // 8 holds rows 2t, 2t + 1 x columns 2g, 2g + 1
    of that chunk (G % 8 = g), bytes (2t, 2g), (2t, 2g + 1), (2t + 1, 2g),
    (2t + 1, 2g + 1)."""
    O = Wp.shape[1]
    b = Wp[R + 8 * j:R + 8 * j + 8].reshape(4, 2, O // 2, 2).astype(np.uint32)  # [t, r, G, c]
    return (b[:, 0, :, 0] | (b[:, 0, :, 1] << np.uint32(8)) | (b[:, 1, :, 0] << np.uint32(16))
            | (b[:, 1, :, 1] << np.uint32(24)))


def _place(regs, kk: int, values_of):
    """An A operand [kk, O] from a step's four registers by the PTX fragment
    layout: register i holds M row g + 8 (i & 1) at k offset (kk / 2)(i >> 1)
    + 2t (bf16, two halves) or 4t (s8, four bytes); M rows g and g + 8 of
    a warp are columns 2g and 2g + 1 of its 16-column chunk."""
    T, Gn = regs[0].shape
    O = 2 * Gn
    A = np.zeros((kk, O), np.float64)
    G = np.arange(Gn)
    cols = (G // 8) * 16 + 2 * (G % 8)
    for i, r in enumerate(regs):
        vals = values_of(r)  # one [t, G] array a k of the register
        per = len(vals)
        for t in range(T):
            for e, v in enumerate(vals):
                A[(kk // 2) * (i >> 1) + per * t + e, cols + (i & 1)] = v[t]
    return A


def _a_step_k2(Wp, R):
    w0, w1 = _words(Wp, R, 0), _words(Wp, R, 1)
    regs = [*widen8(w0), *widen8(w1)]  # a0 a1 from word 0, a2 a3 from word 1
    return _place(regs, 16, _halves)


def _a_step_k5(Wp, R):
    w = [_words(Wp, R, j) for j in range(4)]
    regs = [_prmt(w[0], w[1], 0x6420), _prmt(w[0], w[1], 0x7531),
            _prmt(w[2], w[3], 0x6420), _prmt(w[2], w[3], 0x7531)]
    sbytes = lambda r: [((r >> np.uint32(8 * e)) & np.uint32(0xFF)).astype(np.uint8).view(np.int8)  # noqa: E731
                        for e in range(4)]
    return _place(regs, 32, sbytes)


def _b_step(words: np.ndarray, q: int, NT: int, a8: bool):
    """Step q of the staged operand as wgmma reads it, [kk, N]: core matrix
    (n-tile, k half) at (2 ntile + khalf) * 128 bytes, its row n % 8 at 16
    bytes, one k at 2 bytes (bf16) or 1 (s8)."""
    N = 8 * NT
    raw = words[q * N * 8:(q + 1) * N * 8].view(np.uint8).reshape(NT, 2, 8, 16)
    if a8:
        v = raw.view(np.int8).astype(np.float64)  # [ntile, khalf, n % 8, k % 16]
    else:
        u = raw.view(np.uint16).astype(np.uint32) << np.uint32(16)
        v = u.view(np.float32).astype(np.float64)  # [ntile, khalf, n % 8, k % 8]
    kh = v.shape[-1]
    return v.transpose(1, 3, 0, 2).reshape(2 * kh, N)


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(torch.bfloat16).float().numpy()


def _bf16_bits(x):
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32)


def stage_pieces(xs: np.ndarray, b0: int, r0: int, pc: int, NT: int, G: int) -> np.ndarray:
    """int8_head.cuh stage_pieces(): the words of K2's operand, three bf16
    pieces of each value, row pair p of the chunk at step p // 8, k half
    (p // 4) % 2, word p % 4, column n = 3b + piece."""
    B, K = xs.shape
    N = 8 * NT
    slots = (N + 2) // 3
    nrows = min(G, B - b0)
    pairs = pc // 2
    x = np.zeros((pairs, slots, 2), np.float32)
    for p in range(pairs):
        for h in range(2):
            k = r0 + 2 * p + h
            if k < K:
                n = min(slots, nrows)
                x[p, :n, h] = xs[b0:b0 + n, k]
    hi = _bf16(x)
    e = x - hi
    mid = _bf16(e)
    pieces = [_bf16_bits(v) for v in (x, e, e - mid)]  # bf16(x - hi - mid), as the kernel rounds
    words = np.zeros(pc * 4 * NT, np.uint32)
    for p in range(pairs):
        base = (p >> 3) * NT * 64 + ((p >> 2) & 1) * 32 + (p & 3)
        for b in range(slots):
            for piece in range(3):
                n = 3 * b + piece
                if n < N:
                    bits = pieces[piece][p, b]
                    words[base + (n >> 3) * 64 + (n & 7) * 4] = bits[0] | (bits[1] << np.uint32(16))
    return words


def row_scales(amax: np.ndarray) -> np.ndarray:
    return np.maximum(amax.astype(np.float32) / np.float32(127.0), np.float32(1e-30))


def stage_codes(xs: np.ndarray, scale: np.ndarray, b0: int, r0: int, pc: int, NT: int):
    """int8_head.cuh stage_codes(): word (u, n), u = 8q + 4h + t, the codes
    of rows 32q + 16h + (2t, 2t + 1, 2t + 8, 2t + 9) of the chunk; also the
    codes block 0 writes out."""
    B, K = xs.shape
    N = 8 * NT
    nrows = min(N, B - b0)
    words = np.zeros(pc * N // 4, np.uint32)
    out = {}
    for u in range(pc // 4):
        q, h, t = u >> 3, (u >> 2) & 1, u & 3
        k0 = r0 + 32 * q + 16 * h + 2 * t
        ks = (k0, k0 + 1, k0 + 8, k0 + 9)
        for b in range(N):
            word = 0
            for i, k in enumerate(ks):
                v = xs[b0 + b, k] if b < nrows and k < K else np.float32(0)
                s = scale[b] if b < nrows else np.float32(1)
                c = int(np.clip(np.rint(np.float32(v) / s), -127, 127))
                word |= (c & 0xFF) << (8 * i)
                if b < nrows and k < K:
                    out[(b0 + b, k)] = c
            words[q * N * 8 + h * 32 + t + (b >> 3) * 64 + (b & 7) * 4] = word
    return words, out


def plan(B: int, K: int, a8: bool, chunk_rows=None):
    """int8_head.cuh plan()'s batch cut: NT, rows a pass, rows a staging."""
    rows = min(B, 16)
    NT = -(-rows // 8) if a8 else -(-3 * rows // 8)
    G = min(16, 8 * NT) if a8 else min(16, 8 * NT // 3)
    J = -(-K // ROWS) * ROWS
    fit = STAGED_BYTES // (8 * NT if a8 else 16 * NT) // ROWS * ROWS
    return NT, G, chunk_rows or min(J, fit)


def head_emulated(xs: torch.Tensor, w: torch.Tensor, *, a8: bool, row_add=None, col_add=None,
                  chunk_rows=None):
    """The kernel's arithmetic: passes of G batch rows, chunks of the
    contraction restaged, 64-row stages of k16 (K2) or k32 (K5) steps.
    Returns out, and for K5 the codes and the scales."""
    x = xs.numpy().astype(np.float32)
    B, K = x.shape
    O = w.shape[1]
    NT, G, cr = plan(B, K, a8, chunk_rows)
    kk = 32 if a8 else 16
    Wp = np.zeros((-(-K // ROWS) * ROWS, O), np.uint8)
    Wp[:K] = w.numpy().view(np.uint8)
    out = np.zeros((B, O), np.float32)
    codes = np.zeros((B, K), np.int8)
    amax = np.abs(x).max(axis=1) if K else np.zeros(B, np.float32)
    for b0 in range(0, B, G):
        rows = min(G, B - b0)
        scale = np.ones(8 * NT, np.float32)
        scale[:rows] = row_scales(amax[b0:b0 + rows])
        acc = np.zeros((O, 8 * NT), np.int64 if a8 else np.float32)
        for r0 in range(0, K, cr):
            if a8:
                words, cs = stage_codes(x, scale, b0, r0, cr, NT)
                for (b, k), c in cs.items():
                    codes[b, k] = c
            else:
                words = stage_pieces(x, b0, r0, cr, NT, G)
            stages = -(-min(cr, K - r0) // ROWS)
            for q in range(stages * ROWS // kk):  # steps, one after another
                R = r0 + q * kk
                if a8:
                    A = _a_step_k5(Wp, R).astype(np.int64)
                    acc += A.T @ _b_step(words, q, NT, True).astype(np.int64)
                else:
                    A = torch.from_numpy(_a_step_k2(Wp, R).astype(np.float32))
                    Bq = torch.from_numpy(_b_step(words, q, NT, False).astype(np.float32))
                    acc = (torch.from_numpy(acc) + A.T @ Bq).numpy()
        for b in range(rows):
            if a8:
                v = acc[:, b].astype(np.float32) * scale[b]
            else:
                v = (acc[:, 3 * b + 2] + acc[:, 3 * b + 1]) + acc[:, 3 * b]
            if row_add is not None:
                v = v + np.float32(row_add[b0 + b])
            if col_add is not None:
                v = v + col_add.numpy()
            out[b0 + b] = v
    if a8:
        return torch.from_numpy(out), torch.from_numpy(codes), torch.from_numpy(row_scales(amax))
    return torch.from_numpy(out)


def _scaled(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def _wide(rng, B, K):
    x = rng.choice([-1.0, 1.0], size=(B, K)) * 10.0 ** rng.uniform(-20, 20, size=(B, K))
    x[rng.random(size=(B, K)) < 0.1] = 0.0
    return x.astype(np.float32)


def test_widen8_gives_every_byte():
    W = np.arange(256, dtype=np.uint32) * np.uint32(0x01010101)  # byte v in all four places
    signed = np.arange(256, dtype=np.uint32).astype(np.uint8).view(np.int8).astype(np.float32)
    for reg in widen8(W):
        lo, hi = _halves(reg)
        np.testing.assert_array_equal(lo, signed)
        np.testing.assert_array_equal(hi, signed)


def test_a_fragments_hold_each_weight_once():
    """Every weight of a step lands at one (k, column) of the A operand: the
    k orders are permutations of the step's rows, the columns the chunk's."""
    rng = np.random.default_rng(3)
    O = 32
    W = rng.integers(-128, 128, size=(64, O), dtype=np.int8)
    Wp = W.view(np.uint8)
    for kk, step in ((16, _a_step_k2), (32, _a_step_k5)):
        for R in range(0, 64, kk):
            A = step(Wp, R)
            block = W[R:R + kk].astype(np.float64)
            for c in range(O):  # the same multiset of values per column
                np.testing.assert_array_equal(np.sort(A[:, c]), np.sort(block[:, c]))
    # K2's k order is the rows' own; K5's rows (2t, 2t + 1, 2t + 8, 2t + 9) of each half
    np.testing.assert_array_equal(_a_step_k2(Wp, 16), W[16:32].astype(np.float64))
    order = [16 * h + 8 * (i >> 1) + 2 * t + (i & 1) for h in range(2) for t in range(4)
             for i in range(4)]
    np.testing.assert_array_equal(_a_step_k5(Wp, 32), W[32 + np.array(order)].astype(np.float64))


@pytest.mark.parametrize("B", [1, 8, 16, 17])
@pytest.mark.parametrize("K,O", [(200, 144), (128, 48)])
def test_k2_emulated_matches_plain(B, K, O):
    rng = np.random.default_rng(B * 13 + K)
    x = _wide(rng, B, K) if B == 8 else (rng.normal(size=(B, K)) / 100).astype(np.float32)
    xs = torch.from_numpy(x)
    w = torch.from_numpy(rng.integers(-128, 128, size=(K, O), dtype=np.int8))
    row = torch.from_numpy(rng.normal(size=B).astype(np.float32))
    col = torch.from_numpy(rng.normal(size=O).astype(np.float32))
    got = head_emulated(xs, w, a8=False, row_add=row, col_add=col)
    ref = mm8_plain(xs, w, row_add=row, col_add=col)
    assert bool(torch.isfinite(got).all())
    assert _scaled(got, ref) <= 1e-5


def test_k2_emulated_chunks_the_contraction():
    """Chunks of 64 rows restaged (the 14B head's K = 5120 at 16 rows takes
    five of 1024), the last one ragged: the same sums, in the same order."""
    rng = np.random.default_rng(11)
    xs = torch.from_numpy(rng.normal(size=(3, 200)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-128, 128, size=(200, 32), dtype=np.int8))
    whole = head_emulated(xs, w, a8=False)
    assert torch.equal(head_emulated(xs, w, a8=False, chunk_rows=64), whole)
    assert _scaled(whole, mm8_plain(xs, w)) <= 1e-5


def test_k2_emulated_matches_jax_mm8():
    rng = np.random.default_rng(7)
    wf = rng.normal(size=(96, 208)).astype(np.float32)
    jq = j_quant.to_signed(j_quant.quantize(wf))
    x = rng.normal(size=(3, 96)).astype(np.float32)
    xs = (x * np.asarray(jq.scale)).astype(np.float32)
    ref = np.asarray(j_mm8.mm8(jnp.asarray(xs), jq.w, interpret=True))
    got = head_emulated(torch.from_numpy(xs), torch.from_numpy(np.array(jq.w)), a8=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _a8_rows(rng, B, K):
    x = (rng.normal(size=(B, K)) / 100).astype(np.float32)
    x[0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]  # s = 1: ties at .5
    if B > 2:
        x[2] = 0.0  # an all-zero row: the 1e-30 floor of the scale
    return x


@pytest.mark.parametrize("B", [1, 8, 16, 17])
@pytest.mark.parametrize("K,O", [(200, 144), (300, 48)])
def test_k5_emulated_is_plain_bit_for_bit(B, K, O):
    rng = np.random.default_rng(B * 5 + K)
    xs = torch.from_numpy(_a8_rows(rng, B, K))
    w = torch.from_numpy(rng.integers(-128, 128, size=(K, O), dtype=np.int8))
    row = torch.from_numpy(rng.normal(size=B).astype(np.float32))
    col = torch.from_numpy(rng.normal(size=O).astype(np.float32))
    got, codes, scale = head_emulated(xs, w, a8=True, row_add=row, col_add=col)
    q, s = quant_rows(xs)
    assert torch.equal(codes, q) and torch.equal(scale, s)
    assert torch.equal(got, mm8_a8_plain(xs, w, row_add=row, col_add=col))


def test_k5_emulated_chunks_the_contraction():
    rng = np.random.default_rng(19)
    xs = torch.from_numpy(_a8_rows(rng, 5, 300))
    w = torch.from_numpy(rng.integers(-128, 128, size=(300, 32), dtype=np.int8))
    got, codes, _ = head_emulated(xs, w, a8=True, chunk_rows=128)
    assert torch.equal(got, mm8_a8_plain(xs, w))
    assert torch.equal(codes, quant_rows(xs)[0])


@pytest.mark.parametrize("B", [1, 16])
def test_k5_emulated_matches_jax_mm8_a8(B):
    rng = np.random.default_rng(B)
    x = _a8_rows(rng, B, 300)
    w = rng.integers(-128, 128, size=(300, 208), dtype=np.int8)
    ref = np.array(j_mm8.mm8_a8(jnp.asarray(x), jnp.asarray(w), interpret=True))
    got, _, _ = head_emulated(torch.from_numpy(x), torch.from_numpy(w), a8=True)
    assert _scaled(got, ref) <= 1e-6
