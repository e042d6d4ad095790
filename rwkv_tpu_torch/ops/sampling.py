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
draws depend only on its seed, not on its batchmates; temp and tau may then
be [B] tensors.
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
    one per row of a [B, V] batch. temp, tau: floats, or [B] tensors (one per
    row). Returns int64 ids [...]."""
    logits = logits.float()
    per_row = lambda a: a.to(logits.device, torch.float32)[:, None]  # noqa: E731
    if torch.is_tensor(tau):
        tau = per_row(tau)
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
        temp = per_row(temp)
        kept = torch.where(temp != 1.0, torch.pow(kept, 1.0 / temp), kept)
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
