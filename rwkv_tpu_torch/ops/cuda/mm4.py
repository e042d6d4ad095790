"""4-bit-weight matvec (kernel K3; counterpart of rwkv_tpu/ops/pallas/mm4.py).

`mm4(xs, wp, block=None)` computes xs [B, K] f32 @ unpack4(wp, block) ->
[B, O] f32, with wp the nibble-packed [K/2, O] int8 of ops.quant.Quant4Linear
and both nibbles widened in registers (csrc/mm4.cu, which replaces the
Pallas `mm4` / `_mm4_kernel_two_dot`). As for mm8, xs arrives already scaled
by the per-row scale and the caller adds the rank-1 offset term; `row_add`
and `col_add` let the kernel add it, and a logit bias, in its epilogue.

Unlike the Pallas kernel, which rounds its left operand to bf16, the CUDA
kernel keeps f32 activations and f32 sums: it computes what the JAX
package's f32 `q4matmul` computes.

Bound on the card: K * O / 2 packed bytes over device memory bandwidth (the
430M head, 1024 x 50688, is 26 MB: ~7.7 us at 3.35 TB/s).

On CPU tensors the wrapper runs `mm4_plain`; on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from rwkv_tpu_torch.ops.cuda import _build
from rwkv_tpu_torch.ops.quant import Quant4Linear, unpack4

launches = 0  # kernel launches, for showing that a path ran on the kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("mm4")
        lib.rwkv_mm4.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, ctypes.c_longlong,
                                 _P, _I, _I, _P]
        lib.rwkv_mm4.restype = _I
        _lib = lib
    return _lib


def block_half(block: int | None, K: int, what: str = "mm4") -> int:
    """Half the pairing block in rows (K / 2 for None, the global pairing);
    raises unless the block is even and divides K."""
    b = K if block is None else int(block)
    if b <= 0 or b % 2 or K % b:
        raise ValueError(f"{what}: block {block} must be even and divide K = {K}")
    return b // 2


def mm4_plain(xs: torch.Tensor, wp: torch.Tensor, *, block: int | None = None,
              row_add=None, col_add=None) -> torch.Tensor:
    out = torch.matmul(xs, unpack4(wp, block).float())
    if row_add is not None:
        out = out + row_add[:, None]
    if col_add is not None:
        out = out + col_add
    return out


def _need(t: torch.Tensor, name: str, dtype, device, shape) -> None:
    if t.device != device:
        raise ValueError(f"mm4: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"mm4: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"mm4: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"mm4: {name} must be contiguous")


def mm4(xs: torch.Tensor, wp: torch.Tensor, *, block: int | None = None,
        row_add: torch.Tensor | None = None,
        col_add: torch.Tensor | None = None) -> torch.Tensor:
    """xs [B, K] f32 @ unpack4(wp [K/2, O] int8, block) (+ row_add [B, None])
    (+ col_add [O])."""
    if xs.dim() != 2 or wp.dim() != 2:
        raise ValueError(f"mm4: xs {tuple(xs.shape)} and wp {tuple(wp.shape)} must be 2-D")
    B, K = xs.shape
    O = wp.shape[1]
    half = block_half(block, K)
    if xs.device.type == "cpu" and wp.device.type == "cpu":
        return mm4_plain(xs, wp, block=block, row_add=row_add, col_add=col_add)
    global launches
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError(f"mm4 runs on CUDA or CPU tensors, got {dev}")
    _need(xs, "xs", torch.float32, dev, (B, K))
    _need(wp, "wp", torch.int8, dev, (K // 2, O))
    if row_add is not None:
        _need(row_add, "row_add", torch.float32, dev, (B,))
    if col_add is not None:
        _need(col_add, "col_add", torch.float32, dev, (O,))
    if O % 16 or wp.data_ptr() % 16:
        raise ValueError(f"mm4: O ({O}) must be a multiple of 16 and wp 16-byte aligned")
    out = torch.empty((B, O), dtype=torch.float32, device=dev)
    if B == 0 or O == 0:
        return out
    partial, counters, target = _build.split_scratch(dev, "mm4")
    lib = _kernel()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.rwkv_mm4(ptr(xs), ptr(wp), ptr(out), ptr(row_add), ptr(col_add), B, K, O, half,
                       ptr(partial), partial.numel(), ptr(counters), counters.numel(), target,
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "mm4")
    launches += 1
    return out


def qmatmul4_cuda(x: torch.Tensor, q: Quant4Linear) -> torch.Tensor:
    """Drop-in for ops.quant.q4matmul on the mm4 kernel (counterpart of
    qmatmul4_pallas). x: [..., K]; q.wp: [K/2, O] int8. Returns [..., O] f32."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    xb = x.reshape(-1, K)
    main = mm4((xb * q.scale).contiguous(), q.wp, block=q.block)
    off = (xb @ q.offset)[:, None]
    return (main + off).reshape(lead + (q.wp.shape[-1],))
