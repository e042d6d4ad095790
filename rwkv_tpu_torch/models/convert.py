"""Carry weights across from a nested dict of numpy arrays.

`params_from_numpy` takes the tree that `dataclasses.asdict(params)` gives
for the JAX package's RWKVParams once every leaf is a numpy array (the same
field names: emb, ln0/ln1/ln2/ln_out {weight, bias}, att/ffn families,
head, logit_bias) and returns the port's RWKVParams on `device`. A family
is a QuantLinear {w, scale, offset} (u8 codes come out re-centered to
int8), a Quant4Linear {wp, scale, offset, block}, or a dense [in, out]
array.
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
from rwkv_tpu_torch.ops.quant import Quant4Linear, QuantLinear


def _lin(d):
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    if not isinstance(d, dict):
        return f32(d)
    if set(d) == {"w", "scale", "offset"}:
        return QuantLinear(w=np.asarray(d["w"]), scale=f32(d["scale"]), offset=f32(d["offset"]))
    if set(d) == {"wp", "scale", "offset", "block"}:
        return Quant4Linear(wp=np.asarray(d["wp"]), scale=f32(d["scale"]),
                            offset=f32(d["offset"]), block=d["block"])
    raise TypeError(f"params_from_numpy: unknown matrix family with fields {sorted(d)}")


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
