"""Int8-weight matvec (kernel K2; counterpart of rwkv_tpu/ops/pallas/mm8.py).

`mm8(xs, w)` computes xs [B, K] f32 @ w [K, O] int8 -> [B, O] f32, the
weight widened in registers (csrc/mm8.cu, which replaces the Pallas
`mm8` / `_mm8_kernel_f32`). As in the JAX package, xs arrives already scaled
by the per-row scale and the caller adds the rank-1 offset term; `row_add`
and `col_add` let the kernel add it, and a logit bias, in its epilogue.

Bound on the card: K * O weight bytes over device memory bandwidth (the
decode head, 1024 x 50688, is 52 MB: ~16 us at 3.35 TB/s). csrc/qmv.cuh says
what the design does about it.

On CPU tensors the wrapper runs `mm8_plain`, the plain PyTorch version; on
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from rwkv_tpu_torch.ops.cuda import _build
from rwkv_tpu_torch.ops.quant import QuantLinear

launches = 0  # kernel launches, for showing that a path ran on the kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("mm8")
        lib.rwkv_mm8.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P, ctypes.c_longlong,
                                 _P, _I, _I, _P]
        lib.rwkv_mm8.restype = _I
        _lib = lib
    return _lib


def mm8_plain(xs: torch.Tensor, w: torch.Tensor, *, row_add=None, col_add=None) -> torch.Tensor:
    out = torch.matmul(xs, w.float())
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
    partial, counters, target = _build.split_scratch(dev, "mm8")
    lib = _kernel()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.rwkv_mm8(ptr(xs), ptr(w), ptr(out), ptr(row_add), ptr(col_add), B, K, O,
                       ptr(partial), partial.numel(), ptr(counters), counters.numel(), target,
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "mm8")
    launches += 1
    return out


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
