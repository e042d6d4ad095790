"""LayerNorm over the channel dim (counterpart of rwkv_tpu/ops/layernorm.py).

Population variance plus a tiny eps (1e-8), exactly as the JAX package: the
reference divides by sqrt(var) with no eps at all, and 1e-8 is far below
the u8 quantization noise.

The mean and the variance are summed in float64 (exact products of f32
values) and rounded once, and 1 / sqrt is two correctly rounded operations:
the decode kernels' row kernel (csrc/decode_stack.cu) does the same, so the
two give the same bits whatever order each sums in, short of a rounding tie.
The W8A8 step needs that: its int8 codes round the LayerNorm's outputs, and
a code one apart changes every later layer.
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               *, eps: float = 1e-8) -> torch.Tensor:
    def mean64(a):  # a true division (see ops/cuda/mm8.py's quant_rows)
        s = a.sum(dim=-1, keepdim=True)
        return (s / torch.full_like(s, a.shape[-1])).float()

    mean = mean64(x.double())
    centered = x - mean
    c = centered.double()
    var = mean64(c * c)
    return centered * torch.reciprocal(torch.sqrt(var + eps)) * weight + bias
