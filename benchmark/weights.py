"""Random RWKV-4 weights in the served q8 format, made on the device from the
seed: the benchmark's own copy of the recipe of the program's
random_quantized_params_np.

Every matrix family is int8 codes, uniform over [-128, 127], with a scale
and an offset per input channel, already re-centred to signed codes:
W = code * scale + offset. The scales are sized like a quantized
N(0, 1/sqrt(in)) matrix (a span of 8 / sqrt(in), about +-4 sigma, over 255
levels), each channel's times U(0.5, 1.5); each offset centres its channel's
codes and is moved by N(0, 16) of its scale. So a product that applied the
scales or offsets on the wrong axis, or one of them for every channel, gives
other numbers. The embedding is N(0, 0.1), the mixes U(0.1, 0.9), decay
-exp(N(0, 1)), bonus N(0, 0.5), the norms' weights N(1, 0.1) and biases
N(0, 0.1). The vocab is padded to a multiple of `vocab_pad_multiple`: the
padded embedding rows are zero and their logits carry a -1e9 bias.

The weights are a plain dict of tensors that both sides read: the program
through `program_params` (its own parameter classes around the same tensors)
and the reference directly. Nothing the program derives from them is handed
to the reference.
"""

from __future__ import annotations

import math

import torch

MATRICES = ("att_key", "att_value", "att_receptance", "att_output",
            "ffn_key", "ffn_value", "ffn_receptance")


def shapes(cfg: dict) -> dict:
    """[in, out] of every matrix family (per layer) and of the head."""
    E, F, Vp = cfg["hidden_size"], cfg["intermediate_size"], padded_vocab(cfg)
    return {"att_key": (E, E), "att_value": (E, E), "att_receptance": (E, E),
            "att_output": (E, E), "ffn_key": (E, F), "ffn_value": (F, E),
            "ffn_receptance": (E, E), "head": (E, Vp)}


def padded_vocab(cfg: dict) -> int:
    m = cfg["vocab_pad_multiple"]
    return -(-cfg["vocab_size"] // m) * m


def make(cfg: dict, seed: int, device) -> dict:
    """The weights of `cfg` from `seed`, drawn on `device` by one generator,
    one call a tensor."""
    L, E, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    Vp = padded_vocab(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device) * std

    def mix(shape):
        return 0.1 + 0.8 * torch.rand(shape, generator=g, device=device)

    def quantized(lead, k, n):
        codes = torch.randint(-128, 128, lead + (k, n), generator=g, device=device,
                              dtype=torch.int8)
        scale = (8.0 / math.sqrt(k) / 255.0) * (0.5 + torch.rand(lead + (k,), generator=g,
                                                                 device=device))
        offset = scale * (0.5 + 16.0 * torch.randn(lead + (k,), generator=g, device=device))
        return codes, scale, offset

    w = {"emb": torch.zeros((Vp, E), device=device)}
    w["emb"][:V] = normal((V, E), 0.1)
    for ln, lead in (("ln0", ()), ("ln1", (L,)), ("ln2", (L,)), ("ln_out", ())):
        w[ln + "_w"] = 1.0 + normal(lead + (E,), 0.1)
        w[ln + "_b"] = normal(lead + (E,), 0.1)
    w.update(att_mix_k=mix((L, E)), att_mix_v=mix((L, E)), att_mix_r=mix((L, E)),
             att_decay=-torch.exp(normal((L, E), 1.0)), att_bonus=normal((L, E), 0.5),
             ffn_mix_k=mix((L, E)), ffn_mix_r=mix((L, E)))
    for name, (k, n) in shapes(cfg).items():
        w[name] = quantized(() if name == "head" else (L,), k, n)
    w["logit_bias"] = torch.where(torch.arange(Vp, device=device) < V,
                                  torch.zeros((), device=device),
                                  torch.full((), -1e9, device=device))
    return w


def program_params(w: dict):
    """The program's parameter tree around the same tensors (no copy)."""
    from rwkv_tpu_torch.models.rwkv4 import AttParams, FFNParams, LNParams, RWKVParams
    from rwkv_tpu_torch.ops.quant import QuantLinear

    q = {name: QuantLinear(*w[name]) for name in MATRICES + ("head",)}
    return RWKVParams(
        emb=w["emb"], ln0=LNParams(w["ln0_w"], w["ln0_b"]),
        ln1=LNParams(w["ln1_w"], w["ln1_b"]), ln2=LNParams(w["ln2_w"], w["ln2_b"]),
        att=AttParams(mix_k=w["att_mix_k"], mix_v=w["att_mix_v"], mix_r=w["att_mix_r"],
                      key=q["att_key"], value=q["att_value"], receptance=q["att_receptance"],
                      output=q["att_output"], decay=w["att_decay"], bonus=w["att_bonus"]),
        ffn=FFNParams(mix_k=w["ffn_mix_k"], mix_r=w["ffn_mix_r"], key=q["ffn_key"],
                      value=q["ffn_value"], receptance=q["ffn_receptance"]),
        ln_out=LNParams(w["ln_out_w"], w["ln_out_b"]), head=q["head"],
        logit_bias=w["logit_bias"])
