"""LayerNorm over the channel dim (counterpart of rwkv_tpu/ops/layernorm.py).

Population variance plus a tiny eps (1e-8), exactly as the JAX package: the
reference divides by sqrt(var) with no eps at all, and 1e-8 is far below
the u8 quantization noise.
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               *, eps: float = 1e-8) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    return centered * torch.rsqrt(var + eps) * weight + bias
