"""On-device samplers (counterpart of rwkv_tpu/ops/sampling.py).

`typical` keeps the reference's typical-sampling semantics:
  1. p = softmax(logits); surprisal s = -log p
  2. entropy H = sum(p * s); shifted = |s - H|
  3. keep the tokens with the smallest `shifted` until their cumulative
     probability reaches tau (exactly the positions with
     shifted <= sorted_shifted[#(cumsum < tau)])
  4. temperature as probs ** (1/temp), on the kept probabilities
  5. draw from the renormalized weights.
The draw takes its noise from an explicit torch.Generator on the logits'
device, so only the chosen id ever needs to reach the host. Given one
generator per row (the pool's slots, counterpart of the JAX pool's vmapped
per-slot keys), row b draws from its own generator alone, so a stream's
draws depend only on its seed, not on its batchmates.

temp and tau may be Python floats, or tensors: 0-d (one value for every
row) or [B] (one per row). The tensor path never branches in Python on
their values, so a CUDA graph captured with it reads them from their
buffers at every replay (runtime/graphs.py); and it draws the ids the float
path draws: tau is compared in float32 as a float is, and a float64 temp
gives the exponent 1 / temp that torch.pow takes from a Python float,
special cases included (_temper).
"""

from __future__ import annotations

from typing import Sequence

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last dim."""
    return torch.argmax(logits, dim=-1)


def typical(logits: torch.Tensor, generator: torch.Generator | Sequence[torch.Generator],
            temp: float | torch.Tensor = 0.9, tau: float | torch.Tensor = 0.8) -> torch.Tensor:
    """Typical sampling. logits: [..., V]. generator: one torch.Generator, or
    one per row of a [B, V] batch. temp, tau: floats, or 0-d or [B] tensors
    (temp in float64 to draw exactly what the same float draws). Returns
    int64 ids [...]."""
    logits = logits.float()

    def per_row(a, dtype):  # 0-d -> [1], [B] -> [B, 1]: broadcast over V
        a = a.to(logits.device, dtype)
        return a.reshape(a.shape + (1,))

    if torch.is_tensor(tau):
        tau = per_row(tau, torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(logp)
    ent = -torch.where(probs > 0, probs * logp, torch.zeros_like(probs)).sum(
        dim=-1, keepdim=True)
    shifted = torch.abs(-logp - ent)

    sorted_shifted, order = torch.sort(shifted, dim=-1, stable=True)
    cum = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
    cutoff = (cum < tau).sum(dim=-1, keepdim=True).clamp(max=shifted.shape[-1] - 1)
    threshold = torch.gather(sorted_shifted, -1, cutoff)
    kept = torch.where(shifted > threshold, torch.zeros_like(probs), probs)
    if torch.is_tensor(temp):
        kept = _temper(kept, per_row(temp, torch.float64))
    elif temp != 1.0:
        kept = torch.pow(kept, 1.0 / temp)

    # categorical draw by the Gumbel-max trick over log-weights
    logw = torch.where(kept > 0, torch.log(kept),
                       torch.full_like(kept, float("-inf")))
    if isinstance(generator, torch.Generator):
        u = torch.rand(logw.shape, generator=generator, device=logw.device)
    else:
        if logw.dim() != 2 or len(generator) != logw.shape[0]:
            raise ValueError(f"{len(generator)} generators for logits {tuple(logw.shape)}: "
                             "one per row of a [B, V] batch")
        u = torch.stack([torch.rand(logw.shape[1:], generator=g, device=logw.device)
                         for g in generator])
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logw + gumbel, dim=-1)


def _temper(kept: torch.Tensor, temp: torch.Tensor) -> torch.Tensor:
    """kept ** (1 / temp) as torch.pow(kept, 1 / temp) gives it for a Python
    float temp, and kept itself where temp is 1: the exponent is the float64
    inverse rounded to float32, and the exponents that torch.pow special-cases
    for a scalar (2, 3 and 0.5: x * x, x * x * x and sqrt) take the same
    arithmetic here. temp: float64, broadcastable against kept."""
    inv = 1.0 / temp
    out = torch.pow(kept, inv.to(torch.float32))
    out = torch.where(inv == 2.0, kept * kept, out)
    out = torch.where(inv == 3.0, kept * kept * kept, out)
    out = torch.where(inv == 0.5, torch.sqrt(kept), out)
    return torch.where(temp == 1.0, kept, out)
