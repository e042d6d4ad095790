"""Frozen arithmetic of the benchmark: the bytes and operations that the
served RWKV-4 q8 model needs, from its shapes, and the published peaks of
the card. Each input byte is counted once and each output byte written
once, whatever kernel or kernels do the work; element-wise work (LayerNorm,
the WKV recurrence, sampling) is left out of the operation counts, a few
tens of operations a channel against the matrices' 2 * E per channel.
"""

from __future__ import annotations

from benchmark.weights import padded_vocab

# NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet, dense rates at the 700 W limit
PEAK_HBM_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores (float32 prefill, TF32 off)
PEAK_BF16_FLOPS = 989e12    # bf16 on the tensor cores
# A decode step's products take int8 codes and float32 activations; they are
# counted at the bf16 tensor cores' peak, whatever a kernel does today, so a
# least time describes the work and not one implementation of it.

F32 = 4


def dims(cfg: dict):
    return (cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"],
            padded_vocab(cfg))


def layer_weight_params(cfg: dict) -> int:
    """Codes of one layer's seven matrices: att k, v, r, output (E x E each),
    ffn receptance (E x E), key (E x F), value (F x E)."""
    _, E, F, _ = dims(cfg)
    return 5 * E * E + 2 * E * F


def weight_bytes_per_token(cfg: dict) -> int:
    """Bytes one decode step reads of the weights (the program's
    tools/bench.py arithmetic, frozen): every matrix's int8 codes with their
    float32 scale and offset per input channel, the norms, mixes, decay and
    bonus, the logit bias, and one embedding row, which is gathered."""
    L, E, F, Vp = dims(cfg)
    per_layer = (layer_weight_params(cfg)
                 + F32 * 2 * (4 * E + E + E + F)      # scale + offset of each family
                 + F32 * (4 * E + 5 * E + 2 * E))     # ln1, ln2; five mixes; decay, bonus
    head = E * Vp + F32 * 2 * E
    return L * per_layer + head + F32 * (4 * E + Vp + E)  # ln0, ln_out; bias; emb row


def state_bytes(cfg: dict, batch: int) -> int:
    """The recurrent state of `batch` streams: five float32 [L, E] tensors."""
    L, E, _, _ = dims(cfg)
    return 5 * L * batch * E * F32


def stack_bytes(cfg: dict, batch: int) -> int:
    """Decode stack (kernel K1): the layers' weights and norms, the embedding
    rows, the state read and written, the head's scaled input and row
    offset written."""
    L, E, F, Vp = dims(cfg)
    head = E * Vp + F32 * Vp  # the head's codes and the bias, read by K2
    return (weight_bytes_per_token(cfg) - head + F32 * (batch - 1) * E
            + 2 * state_bytes(cfg, batch) + F32 * batch * (E + 1))


def head_bytes(cfg: dict, batch: int) -> int:
    """Head (kernel K2): int8 codes [E, Vp], the scaled input [B, E], the row
    offsets [B] and the bias [Vp] read, the logits [B, Vp] written."""
    _, E, _, Vp = dims(cfg)
    return E * Vp + F32 * (batch * E + batch + Vp + batch * Vp)


def stack_flops(cfg: dict, batch: int) -> int:
    """Multiply-adds of the layers' matrices, twice, for `batch` tokens."""
    L = cfg["num_hidden_layers"]
    return 2 * batch * L * layer_weight_params(cfg)


def head_flops(cfg: dict, batch: int) -> int:
    _, E, _, Vp = dims(cfg)
    return 2 * batch * E * Vp


def stack_least_s(cfg: dict, batch: int) -> float:
    """K1's least time: its bytes over the HBM peak or its products on the
    bf16 tensor cores, whichever is longer."""
    return max(stack_bytes(cfg, batch) / PEAK_HBM_BYTES_S,
               stack_flops(cfg, batch) / PEAK_BF16_FLOPS)


def head_least_s(cfg: dict, batch: int) -> float:
    """K2's least time: its bytes, or its products on the bf16 tensor cores."""
    return max(head_bytes(cfg, batch) / PEAK_HBM_BYTES_S,
               head_flops(cfg, batch) / PEAK_BF16_FLOPS)


def decode_step_least_s(cfg: dict, batch: int) -> float:
    """One decode step of the whole model: the weight and state bytes over
    the HBM peak, or the products on the bf16 tensor cores, whichever is
    longer. It names no kernel."""
    by_bytes = (stack_bytes(cfg, batch) + head_bytes(cfg, batch)) / PEAK_HBM_BYTES_S
    by_flops = (stack_flops(cfg, batch) + head_flops(cfg, batch)) / PEAK_BF16_FLOPS
    return max(by_bytes, by_flops)


def prefill_flops(cfg: dict, prompt_tokens: int, requests: int) -> int:
    """Products that ingesting `prompt_tokens` tokens of `requests` prompts
    needs in float32: every token through every layer's matrices, and the
    head once per request for its first token's logits."""
    return stack_flops(cfg, prompt_tokens) + head_flops(cfg, requests)
