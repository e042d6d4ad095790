"""Carry weights across from a nested dict of numpy arrays.

`params_from_numpy` takes the tree that `dataclasses.asdict(params)` gives
for the JAX package's RWKVParams once every leaf is a numpy array (the same
field names: emb, ln0/ln1/ln2/ln_out {weight, bias}, att/ffn families,
QuantLinear {w, scale, offset}, head, logit_bias) and returns the port's
RWKVParams on `device`, with u8 families re-centered to int8.
"""

from __future__ import annotations

import numpy as np

from rwkv_tpu_torch.models.rwkv4 import (
    AttParams,
    FFNParams,
    LNParams,
    RWKVParams,
    params_to,
    signedize_params,
)
from rwkv_tpu_torch.ops.quant import QuantLinear


def _lin(d) -> QuantLinear:
    if not isinstance(d, dict) or set(d) != {"w", "scale", "offset"}:
        raise TypeError("params_from_numpy needs quantized families "
                        "({'w', 'scale', 'offset'} dicts)")
    return QuantLinear(w=np.asarray(d["w"]), scale=np.asarray(d["scale"], np.float32),
                       offset=np.asarray(d["offset"], np.float32))


def params_from_numpy(tree: dict, device) -> RWKVParams:
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    ln = lambda d: LNParams(f32(d["weight"]), f32(d["bias"]))  # noqa: E731
    att, ffn = tree["att"], tree["ffn"]
    params = RWKVParams(
        emb=f32(tree["emb"]),
        ln0=ln(tree["ln0"]), ln1=ln(tree["ln1"]), ln2=ln(tree["ln2"]),
        att=AttParams(
            mix_k=f32(att["mix_k"]), mix_v=f32(att["mix_v"]),
            mix_r=f32(att["mix_r"]),
            key=_lin(att["key"]), value=_lin(att["value"]),
            receptance=_lin(att["receptance"]), output=_lin(att["output"]),
            decay=f32(att["decay"]), bonus=f32(att["bonus"]),
        ),
        ffn=FFNParams(
            mix_k=f32(ffn["mix_k"]), mix_r=f32(ffn["mix_r"]),
            key=_lin(ffn["key"]), value=_lin(ffn["value"]),
            receptance=_lin(ffn["receptance"]),
        ),
        ln_out=ln(tree["ln_out"]),
        head=_lin(tree["head"]),
        logit_bias=(None if tree.get("logit_bias") is None
                    else f32(tree["logit_bias"])),
    )
    # signedize on the host (numpy XOR path), then upload once
    return params_to(signedize_params(params), device)
