"""Weight-only quantization, 8-bit and 4-bit (counterpart of
rwkv_tpu/ops/quant.py).

A weight in the matmul layout [in, out] (y = x @ W) is stored as uint8 (or,
after `to_signed`, int8) codes with a per-input-channel scale r and offset o:
W ~= Q * r[:, None] + o[:, None]. The product never materializes W:

    y = x @ (Q*r + o) = (x * r) @ Q + (x . o)

The offset term is rank-1 (one scalar per row of x). The 4-bit format
(`Quant4Linear`) keeps the same identity with 16 levels and two codes per
byte. The hand-written kernels (ops/cuda/) widen the codes in registers;
`qmatmul` and `q4matmul` here are the plain versions that prefill and the
CPU path use. `quantize` and `quantize4` run the JAX package's float64
numpy arithmetic, so both packages produce the same codes bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class QuantLinear:
    """y = x @ dequant(w). May carry a leading stacked-layer dim:
    w [L?, in, out] uint8 or int8, scale/offset [L?, in] float32."""

    w: torch.Tensor | np.ndarray
    scale: torch.Tensor | np.ndarray
    offset: torch.Tensor | np.ndarray

    @property
    def in_features(self) -> int:
        return self.w.shape[-2]

    @property
    def out_features(self) -> int:
        return self.w.shape[-1]


def to_signed(q: QuantLinear) -> QuantLinear:
    """Re-center storage to int8: W8*r + o == (W8-128)*r + (o + 128*r).

    The kernels take int8 only. On numpy arrays this is the host path:
    u8 x -> x-128 as int8 is the XOR-0x80 bit pattern, one family-sized
    host copy before upload. Torch tensors are re-centered where they lie.
    """
    if isinstance(q.w, np.ndarray):
        if q.w.dtype == np.int8:
            return q
        w = (q.w ^ np.uint8(0x80)).view(np.int8)
        return QuantLinear(w=w, scale=q.scale,
                           offset=q.offset + np.float32(128.0) * q.scale)
    if q.w.dtype == torch.int8:
        return q
    if q.w.dtype != torch.uint8:
        raise TypeError(f"to_signed needs uint8 or int8 codes, got {q.w.dtype}")
    w = (q.w.to(torch.int16) - 128).to(torch.int8)
    return QuantLinear(w=w, scale=q.scale, offset=q.offset + 128.0 * q.scale)


def host_array(w) -> np.ndarray:
    """A numpy array from a numpy array or a tensor on any device."""
    return w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)


def quantize(w) -> QuantLinear:
    """Quantize a dense [..., in, out] weight (numpy or torch) to u8
    QuantLinear with numpy leaves: per-input-channel min/max affine over 256
    levels, codes truncated toward zero, and the offset refined by the mean
    fractional residue (the reference converter's quantize_matrix). Stacked
    inputs quantize layer by layer, so the float64 temporary is one layer."""
    x = host_array(w)
    o = x.min(axis=-1).astype(np.float64)
    span = x.max(axis=-1).astype(np.float64) - o
    r = np.where(span > 0, span, 255.0) / 255.0  # all-equal rows: Q = 0
    qu8 = np.empty(x.shape, np.uint8)
    fmean = np.empty(o.shape, np.float64)
    for idx in (np.ndindex(x.shape[:-2]) if x.ndim > 2 else [()]):
        q = (x[idx] - o[idx][..., None]) / r[idx][..., None]
        qu8[idx] = q.astype(np.uint8)
        fmean[idx] = (q - qu8[idx]).mean(axis=-1)
    o = o + fmean * r
    return QuantLinear(w=qu8, scale=r.astype(np.float32), offset=o.astype(np.float32))


def dequantize(q: QuantLinear, dtype=torch.float32) -> torch.Tensor:
    """The dense weight Q * scale + offset (tests and debugging; numpy or
    tensor leaves). On u8 codes it is the JAX dequantize bit for bit; on
    int8 codes, (Q - 128) * scale + (offset + 128 * scale), the same weight
    up to the float32 rounding of the folded offset."""
    w = torch.as_tensor(q.w)
    scale, offset = torch.as_tensor(q.scale), torch.as_tensor(q.offset)
    return (w.to(dtype) * scale[..., None].to(dtype)
            + offset[..., None].to(dtype))


@dataclasses.dataclass
class Quant4Linear:
    """y = x @ dequant4(wp), 4-bit codes, two per byte.

    wp [L?, K/2, O] int8 is split-half packed along K: the low nibble holds
    the unsigned code q of row j, the high nibble the two's-complement q - 8
    of row j + b/2, both inside the same `block`-row group (b = K when
    block is None, the global pairing). `offset` already includes the
    +8 * scale re-centering, so dequant4 = (q - 8) * scale + offset on both
    halves. scale/offset [L?, K] float32."""

    wp: torch.Tensor | np.ndarray
    scale: torch.Tensor | np.ndarray
    offset: torch.Tensor | np.ndarray
    block: int | None = None

    @property
    def in_features(self) -> int:
        return self.wp.shape[-2] * 2

    @property
    def out_features(self) -> int:
        return self.wp.shape[-1]


def quantize4(w, *, block: int | None = None) -> Quant4Linear:
    """Quantize a dense [..., K, O] weight (numpy or torch) to Quant4Linear
    with numpy leaves: per-input-channel affine over 16 levels, round to
    nearest, the same mean-residue offset refinement as `quantize`, then
    split-half packing within each `block`-row group (None: the whole K)."""
    x = host_array(w)
    K = x.shape[-2]
    b = K if block is None else block
    if b <= 0 or b % 2 or K % b:
        raise ValueError(f"quantize4: block {block} must be even and divide K = {K}")
    o = x.min(axis=-1).astype(np.float64)
    span = x.max(axis=-1).astype(np.float64) - o
    r = np.where(span > 0, span, 15.0) / 15.0
    codes = np.empty(x.shape, np.uint8)
    fmean = np.empty(o.shape, np.float64)
    for idx in (np.ndindex(x.shape[:-2]) if x.ndim > 2 else [()]):
        q = (x[idx] - o[idx][..., None]) / r[idx][..., None]
        qr = np.clip(np.rint(q), 0, 15)
        codes[idx] = qr.astype(np.uint8)
        fmean[idx] = (q - qr).mean(axis=-1)
    o = o + fmean * r + 8.0 * r  # signed centering folded in
    lead, O = x.shape[:-2], x.shape[-1]
    cb = codes.reshape(lead + (K // b, b, O))
    lo = cb[..., : b // 2, :]
    hi = (cb[..., b // 2:, :] - 8) & 0xF
    packed = (((hi << 4) | lo).astype(np.uint8).view(np.int8).reshape(lead + (K // 2, O)))
    return Quant4Linear(wp=packed, scale=r.astype(np.float32), offset=o.astype(np.float32),
                        block=block)


def unpack4(wp, block: int | None = None):
    """Centered codes in [-8, 7] ([..., K, O] int32) from the packed
    [..., K/2, O] int8, numpy or torch (the type comes back as it went in)."""
    if isinstance(wp, np.ndarray):
        return unpack4(torch.from_numpy(wp), block).numpy()
    p32 = wp.to(torch.int32)
    low = p32 & 0xF
    w_lo = low - 8                # block rows [0, b/2)
    w_hi = (p32 - low) >> 4       # rows [b/2, b): the sign-extended high nibble
    K2, O = wp.shape[-2], wp.shape[-1]
    b2 = K2 if block is None else block // 2
    lead = tuple(wp.shape[:-2])
    w_lo = w_lo.reshape(lead + (K2 // b2, b2, O))
    w_hi = w_hi.reshape(lead + (K2 // b2, b2, O))
    return torch.cat([w_lo, w_hi], dim=-2).reshape(lead + (2 * K2, O))


def dequantize4(q: Quant4Linear) -> torch.Tensor:
    """The dense float32 weight (tests only)."""
    w = unpack4(torch.as_tensor(q.wp), q.block).float()
    return w * torch.as_tensor(q.scale)[..., None] + torch.as_tensor(q.offset)[..., None]


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, O], accumulated and returned in float32 (the JAX
    package's dot_general with preferred_element_type=float32).

    float32 operands: torch.matmul. bf16 operands on CUDA: one cuBLAS call
    with a float32 output (torch.mm's out_dtype), so the product is not
    rounded to bf16 a second time, as torch.matmul of two bf16 tensors
    would. On the CPU, where that op has no kernel, the operands widen to
    float32 and multiply there: products of bf16 values are exact in
    float32, so the result is the same accumulation of the same products."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def q4matmul(x: torch.Tensor, q: Quant4Linear, compute_dtype=torch.float32) -> torch.Tensor:
    """y = x @ dequant4(q) = (x * scale) @ unpack4(wp, block) + x . offset.

    The plain version (prefill and the CPU path): the codes are widened to
    compute_dtype and the product goes to dot_f32, as the JAX package leaves
    it to XLA. compute_dtype=torch.bfloat16 (bf16 prefill) rounds x * scale
    to bf16, the codes (-8..7) are exact there, and the product accumulates
    in float32; the offset term stays in float32."""
    xs = (x * q.scale).to(compute_dtype)
    main = dot_f32(xs, unpack4(q.wp, q.block).to(compute_dtype))
    return main + (x * q.offset).sum(dim=-1, keepdim=True)


def qmatmul(x: torch.Tensor, q: QuantLinear, compute_dtype=torch.float32) -> torch.Tensor:
    """y = x @ dequant(q) through the rank-1 offset split.

    x: [..., in]; q.w: [in, out]. Returns [..., out] float32. The weight
    widened to compute_dtype goes to dot_f32: this is the plain version
    (prefill and the CPU path), as the JAX package leaves the same product
    to XLA. compute_dtype=torch.bfloat16 (bf16 prefill) rounds x * scale to
    bf16, the int8 codes are exact there, and the product accumulates in
    float32; the offset term stays in float32."""
    xs = (x * q.scale).to(compute_dtype)
    main = dot_f32(xs, q.w.to(compute_dtype))
    off = (x * q.offset).sum(dim=-1, keepdim=True)
    return main + off
