"""Int8-weight heads: kernel K2, and the W8A8 head of kernel K5
(counterpart of rwkv_tpu/ops/pallas/mm8.py).

`mm8(xs, w)` computes xs [B, K] f32 @ w [K, O] int8 -> [B, O] f32
(csrc/mm8.cu, which replaces the Pallas `mm8` / `_mm8_kernel_f32`). As in
the JAX package, xs arrives already scaled by the per-row scale and the
caller adds the rank-1 offset term; `row_add` and `col_add` let the kernel
add it, and a logit bias, in its epilogue.

`mm8_a8(xs, w)` is the W8A8 product (csrc/mm8_a8.cu, which replaces the
Pallas `mm8_a8` / `_mm8_a8_kernel`): each row of xs is quantized to int8
codes with its own scale, sx = max|row| / 127 (floored at 1e-30), codes =
clip(round-half-even(xs / sx), -127, 127); then codes x w in exact integer
sums, times sx.

Both kernels stream the weight through a TMA ring in shared memory once for
up to 16 batch rows and multiply on the tensor cores (wgmma, csrc/
int8_head.cuh): K2 widens each byte to an exact bf16 integer and splits each
activation into three bf16 pieces whose sum is the f32 value, so the only
rounding is the f32 accumulation; K5's head multiplies the codes s8 x s8 ->
s32, exactly, and rounds as `mm8_a8_plain` does, to the same bits. Bound on
the card: K * O weight bytes over device memory bandwidth (the decode head,
1024 x 50688, is 52 MB: ~15.5 us at 3.35 TB/s).

On CPU tensors each wrapper runs its plain PyTorch version (`mm8_plain`,
`mm8_a8_plain`); on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from rwkv_tpu_torch.ops.cuda import _build
from rwkv_tpu_torch.ops.quant import QuantLinear

# kernel launches, for showing that a path ran on the kernel: mm8 (K2),
# mm8_a8 (K5's head)
launches = 0
launches_a8 = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None
_lib_a8 = None


def _kernel_a8():
    global _lib_a8
    if _lib_a8 is None:
        lib = _build.load("mm8_a8")
        lib.rwkv_mm8_a8.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
        lib.rwkv_mm8_a8.restype = _I
        lib.rwkv_mm8_a8_plan.argtypes = [_I, _I, _I, _I] + [ctypes.POINTER(_I)] * 4
        lib.rwkv_mm8_a8_plan.restype = None
        _lib_a8 = lib
    return _lib_a8


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("mm8")
        lib.rwkv_mm8.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
        lib.rwkv_mm8.restype = _I
        lib.rwkv_mm8_plan.argtypes = [_I, _I, _I, _I] + [ctypes.POINTER(_I)] * 4
        lib.rwkv_mm8_plan.restype = None
        _lib = lib
    return _lib


def mm8_plain(xs: torch.Tensor, w: torch.Tensor, *, row_add=None, col_add=None) -> torch.Tensor:
    out = torch.matmul(xs, w.float())
    if row_add is not None:
        out = out + row_add[:, None]
    if col_add is not None:
        out = out + col_add
    return out


def quant_rows(x: torch.Tensor):
    """Per-row dynamic symmetric int8 quantization (counterpart of the JAX
    decode stack's _quant_rows and of mm8_a8's): x ~= q * s.
    Returns (q int8 [..., K], s f32 [...])."""
    s = _row_scale(x.abs().amax(dim=-1))
    q = torch.clamp(torch.round(x / s[..., None]), -127.0, 127.0).to(torch.int8)
    return q, s


def _row_scale(amax: torch.Tensor) -> torch.Tensor:
    """max|row| / 127, floored at 1e-30, by a true division: on CUDA tensors
    torch turns a division by a Python number into a product with its
    reciprocal, which can be one ulp off the kernels' (and the JAX package's)
    quotient."""
    return torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-30)


def quant_blocks(x: torch.Tensor, block: int):
    """quant_rows over each block of `block` consecutive channels of a row:
    the activation quantization of the a8 decode stack's row-tiled families.
    Returns (q int8 [..., K], s f32 [..., K / block])."""
    K = x.shape[-1]
    if block <= 0 or K % block:
        raise ValueError(f"a8 quantization block {block} does not divide {K}")
    q, s = quant_rows(x.reshape(x.shape[:-1] + (K // block, block)))
    return q.reshape(x.shape), s


def mm8_a8_plain(xs: torch.Tensor, w: torch.Tensor, *, block: int | None = None,
                 row_add=None, col_add=None) -> torch.Tensor:
    """The plain W8A8 product: xs [B, K] quantized per row (or per block of
    `block` channels of a row), codes x w summed exactly (float64 holds every
    sum of K <= 2^39 products of int8 codes exactly), each block's integer
    sum rounded to f32, times its scale, the blocks added in order."""
    B, K = xs.shape
    O = w.shape[-1]
    block = K if block is None else block
    q, s = quant_blocks(xs, block)
    nb = K // block
    acc = torch.einsum("bnk,nko->bno", q.reshape(B, nb, block).double(),
                       w.reshape(nb, block, O).double()).float()
    out = acc[:, 0] * s[:, :1]
    for j in range(1, nb):
        out = out + acc[:, j] * s[:, j:j + 1]
    if row_add is not None:
        out = out + row_add[:, None]
    if col_add is not None:
        out = out + col_add
    return out


def _need(t: torch.Tensor, name: str, dtype, device, shape) -> None:
    if t.device != device:
        raise ValueError(f"mm8: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"mm8: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"mm8: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"mm8: {name} must be contiguous")


def mm8(xs: torch.Tensor, w: torch.Tensor, *, row_add: torch.Tensor | None = None,
        col_add: torch.Tensor | None = None) -> torch.Tensor:
    """xs [B, K] f32 @ w [K, O] int8 (+ row_add [B, None]) (+ col_add [O])."""
    if xs.device.type == "cpu" and w.device.type == "cpu":
        return mm8_plain(xs, w, row_add=row_add, col_add=col_add)
    global launches
    if w.dtype == torch.uint8:
        raise TypeError("mm8 takes int8 weights; apply ops.quant.to_signed at load time")
    if xs.dim() != 2 or w.dim() != 2:
        raise ValueError(f"mm8: xs {tuple(xs.shape)} and w {tuple(w.shape)} must be 2-D")
    B, K = xs.shape
    O = w.shape[1]
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"mm8 runs on CUDA or CPU tensors, got {dev}")
    _need(xs, "xs", torch.float32, dev, (B, K))
    _need(w, "w", torch.int8, dev, (K, O))
    if row_add is not None:
        _need(row_add, "row_add", torch.float32, dev, (B,))
    if col_add is not None:
        _need(col_add, "col_add", torch.float32, dev, (O,))
    if O % 16 or w.data_ptr() % 16:
        raise ValueError(f"mm8: O ({O}) must be a multiple of 16 and w 16-byte aligned")
    out = torch.empty((B, O), dtype=torch.float32, device=dev)
    if B == 0 or O == 0:
        return out
    lib = _kernel()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.rwkv_mm8(ptr(xs), ptr(w), ptr(out), ptr(row_add), ptr(col_add), B, K, O,
                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "mm8")
    launches += 1
    return out


def mm8_a8(xs: torch.Tensor, w: torch.Tensor, *, row_add: torch.Tensor | None = None,
           col_add: torch.Tensor | None = None, amax: torch.Tensor | None = None,
           return_codes: bool = False):
    """W8A8: quantize each row of xs [B, K] f32 to int8, then codes @ w [K, O]
    int8 in exact integer sums, times the row scale (+ row_add [B, None])
    (+ col_add [O]).

    amax: [B] max|xs| per row, where the caller has it (the decode stack's
    ln_out kernel writes it); else the kernel finds it.
    return_codes: also return the int8 codes [B, K] the kernel computed and
    the row scales [B], for holding them against quant_rows."""
    if xs.device.type == "cpu" and w.device.type == "cpu":
        out = mm8_a8_plain(xs, w, row_add=row_add, col_add=col_add)
        return (out,) + quant_rows(xs) if return_codes else out
    global launches_a8
    if w.dtype == torch.uint8:
        raise TypeError("mm8_a8 takes int8 weights; apply ops.quant.to_signed at load time")
    if xs.dim() != 2 or w.dim() != 2:
        raise ValueError(f"mm8_a8: xs {tuple(xs.shape)} and w {tuple(w.shape)} must be 2-D")
    B, K = xs.shape
    O = w.shape[1]
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"mm8_a8 runs on CUDA or CPU tensors, got {dev}")
    _need(xs, "xs", torch.float32, dev, (B, K))
    _need(w, "w", torch.int8, dev, (K, O))
    for name, t, n in (("row_add", row_add, B), ("col_add", col_add, O), ("amax", amax, B)):
        if t is not None:
            _need(t, name, torch.float32, dev, (n,))
    if O % 16 or w.data_ptr() % 16:
        raise ValueError(f"mm8_a8: O ({O}) must be a multiple of 16 and w 16-byte aligned")
    out = torch.empty((B, O), dtype=torch.float32, device=dev)
    row_max = amax if amax is not None else torch.empty((B,), dtype=torch.float32, device=dev)
    codes = torch.empty((B, K), dtype=torch.int8, device=dev) if return_codes else None
    if B and O:
        lib = _kernel_a8()
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        with torch.cuda.device(dev):
            err = lib.rwkv_mm8_a8(ptr(xs), ptr(w), ptr(out), ptr(row_add), ptr(col_add),
                                  ptr(amax), ptr(row_max), ptr(codes), B, K, O,
                                  torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, err, "mm8_a8")
        launches_a8 += 1
    if return_codes:
        return out, codes, _row_scale(row_max)
    return out


def _plan(fn, B: int, K: int, O: int, sms: int) -> dict:
    vals = [ctypes.c_int() for _ in range(4)]
    fn(B, K, O, sms, *(ctypes.byref(v) for v in vals))
    return dict(zip(("mt", "nt", "slabs", "chunk_rows"), (v.value for v in vals)))


def plan(B: int, K: int, O: int, sms: int) -> dict:
    """How K2 cuts a call on a card of `sms` SMs: boxes of 128 columns a
    slab (mt), n-tiles of 8 (nt: three columns a batch row, 16 rows a pass),
    slabs, and the weight rows of one staging of the pieces (chunk_rows)."""
    return _plan(_kernel().rwkv_mm8_plan, B, K, O, sms)


def plan_a8(B: int, K: int, O: int, sms: int) -> dict:
    """How K5's head cuts a call: as `plan`, one column a batch row."""
    return _plan(_kernel_a8().rwkv_mm8_a8_plan, B, K, O, sms)


def qmatmul_cuda(x: torch.Tensor, q: QuantLinear) -> torch.Tensor:
    """Drop-in for ops.quant.qmatmul on the mm8 kernel (counterpart of
    qmatmul_pallas). x: [..., K]; q.w: [K, O] int8. Returns [..., O] f32."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    xb = x.reshape(-1, K)
    xs = (xb * q.scale).contiguous()
    main = mm8(xs, q.w)
    off = (xb @ q.offset)[:, None]
    return (main + off).reshape(lead + (q.w.shape[-1],))
