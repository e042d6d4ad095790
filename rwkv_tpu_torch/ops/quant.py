"""Q8_0-style weight-only quantization (counterpart of rwkv_tpu/ops/quant.py).

A weight in the matmul layout [in, out] (y = x @ W) is stored as uint8 (or,
after `to_signed`, int8) codes with a per-input-channel scale r and offset o:
W ~= Q * r[:, None] + o[:, None]. The product never materializes W:

    y = x @ (Q*r + o) = (x * r) @ Q + (x . o)

The offset term is rank-1 (one scalar per row of x). The hand-written
kernels (ops/cuda/) widen the int8 codes in registers; `qmatmul` here is
the plain version that prefill and the CPU path use.
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


def qmatmul(x: torch.Tensor, q: QuantLinear) -> torch.Tensor:
    """y = x @ dequant(q) through the rank-1 offset split.

    x: [..., in]; q.w: [in, out]. Returns [..., out] float32. The widened
    weight goes to torch.matmul: this is the plain version (prefill and
    the CPU path), as the JAX package leaves the same product to XLA."""
    xs = x * q.scale
    main = torch.matmul(xs, q.w.float())
    off = (x * q.offset).sum(dim=-1, keepdim=True)
    return main + off
