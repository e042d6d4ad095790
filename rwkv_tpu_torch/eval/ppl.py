"""Perplexity evaluation (counterpart of rwkv_tpu/eval/ppl.py).

The quantization quality gate: teacher-forced NLL over a token stream,
chunked through forward_seq(parallel=True, return_all_logits=True) with the
state carried across chunks, so an eval set of any length runs in fixed
memory. The logits stay on the params' device; each chunk's NLL sum and
token count come back to the host in one read.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rwkv_tpu_torch.models.rwkv4 import RWKVParams, forward_seq, init_state


def _chunk_nll(params: RWKVParams, tokens: torch.Tensor, targets: torch.Tensor, length: int,
               state, compute_dtype):
    """Sum of -log p(target) over one chunk and its count of valid positions,
    as one [2] tensor on the device. tokens/targets: [T] (padded);
    positions >= length are no-ops for both the sum and the state."""
    logits, state = forward_seq(params, tokens, state, parallel=True, return_all_logits=True,
                                length=length, compute_dtype=compute_dtype)
    mask = (torch.arange(tokens.shape[0], device=tokens.device) < length).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = logp.gather(-1, targets[:, None])[:, 0]
    return torch.stack([-(tgt * mask).sum(), mask.sum()]), state


def evaluate_nll(params: RWKVParams, token_ids, *, chunk: int = 256,
                 compute_dtype: torch.dtype = torch.float32) -> dict:
    """Mean NLL / perplexity of `token_ids` under the model, on the params'
    device. Predicts token_ids[t+1] from token_ids[:t+1] (standard LM eval).
    compute_dtype=torch.bfloat16 evaluates bf16 prefill's numerics."""
    ids = np.asarray(token_ids, np.int64)
    if ids.size < 2:
        raise ValueError("need at least 2 tokens")
    dev = params.device
    inputs = torch.from_numpy(ids[:-1])
    targets = torch.from_numpy(ids[1:])
    n = inputs.numel()

    state = init_state(params.config, device=dev)
    total_nll = total_cnt = 0.0
    for i in range(0, n, chunk):
        part_in, part_tg = inputs[i:i + chunk], targets[i:i + chunk]
        valid = part_in.numel()
        pad = chunk - valid
        part_in = torch.nn.functional.pad(part_in, (0, pad))
        part_tg = torch.nn.functional.pad(part_tg, (0, pad))
        sums, state = _chunk_nll(params, part_in.to(dev), part_tg.to(dev), valid, state,
                                 compute_dtype)
        nll, cnt = sums.tolist()  # the chunk's one host read
        total_nll += nll
        total_cnt += cnt

    mean_nll = total_nll / total_cnt
    return {
        "tokens": int(total_cnt),
        "nll": mean_nll,
        "ppl": math.exp(mean_nll),
        "bits_per_token": mean_nll / math.log(2),
    }


def compare_quantization(dense_params: RWKVParams, quant_params: RWKVParams, token_ids, *,
                         chunk: int = 256) -> dict:
    """The headline quality metric: ppl(quantized) - ppl(dense)."""
    d = evaluate_nll(dense_params, token_ids, chunk=chunk)
    q = evaluate_nll(quant_params, token_ids, chunk=chunk)
    return {
        "dense_ppl": d["ppl"],
        "quant_ppl": q["ppl"],
        "ppl_delta": q["ppl"] - d["ppl"],
        "nll_delta": q["nll"] - d["nll"],
        "tokens": d["tokens"],
    }
