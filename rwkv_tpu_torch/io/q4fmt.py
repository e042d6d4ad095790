"""Packed-4-bit checkpoint artifact (counterpart of rwkv_tpu/io/q4fmt.py).

    save_q4(path, params)   # params from quantize_params_q4 /
                            # load_checkpoint_quantized(bits=4)
    load_q4(path)           # -> RWKVParams with numpy leaves

A standard .safetensors file with `__metadata__.format = "rwkv-tpu-q4/1"`,
one entry per leaf, and each Quant4Linear's pairing `block` in the metadata
(JSON under "blocks"). The layout and metadata are the JAX package's, so an
artifact written by either package loads in the other.
"""

from __future__ import annotations

import json

import numpy as np

from rwkv_tpu_torch.io.safetensors import SafetensorsFile, write_safetensors
from rwkv_tpu_torch.models.rwkv4 import AttParams, FFNParams, LNParams, RWKVParams
from rwkv_tpu_torch.ops.quant import Quant4Linear, host_array

FORMAT_TAG = "rwkv-tpu-q4/1"

_Q4_FAMS = (
    "att.key", "att.value", "att.receptance", "att.output",
    "ffn.key", "ffn.value", "ffn.receptance", "head",
)
_PLAIN = (
    "emb",
    "ln0.weight", "ln0.bias", "ln1.weight", "ln1.bias",
    "ln2.weight", "ln2.bias", "ln_out.weight", "ln_out.bias",
    "att.mix_k", "att.mix_v", "att.mix_r", "att.decay", "att.bonus",
    "ffn.mix_k", "ffn.mix_r",
)


def _get(params: RWKVParams, dotted: str):
    obj = params
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def save_q4(path: str, params: RWKVParams) -> None:
    """Write packed-q4 RWKVParams (numpy or torch leaves) as a tagged
    .safetensors artifact."""
    blocks, tensors = {}, {}
    for fam in _Q4_FAMS:
        lin = _get(params, fam)
        if not isinstance(lin, Quant4Linear):
            raise TypeError(f"save_q4 requires all matrix families packed 4-bit "
                            f"(quantize_params_q4); {fam} is {type(lin).__name__}")
        tensors[fam + ".wp"] = host_array(lin.wp)
        tensors[fam + ".scale"] = host_array(lin.scale)
        tensors[fam + ".offset"] = host_array(lin.offset)
        blocks[fam] = lin.block
    for name in _PLAIN:
        tensors[name] = host_array(_get(params, name))
    if params.logit_bias is not None:
        tensors["logit_bias"] = host_array(params.logit_bias)
    meta = {
        "format": FORMAT_TAG,
        "n_layer": str(params.n_layer),
        "n_embd": str(params.n_embd),
        "vocab_size": str(params.config.vocab_size),
        "blocks": json.dumps(blocks),
    }
    write_safetensors(path, tensors, metadata=meta)


def is_q4_file(path: str) -> bool:
    """True if `path` is a .safetensors carrying the q4 format tag."""
    if not path.endswith(".safetensors"):
        return False
    try:
        f = SafetensorsFile(path)
    except (ValueError, OSError):
        return False
    try:
        return f.metadata.get("format") == FORMAT_TAG
    finally:
        f.close()


def load_q4(path: str) -> RWKVParams:
    """A save_q4 artifact as RWKVParams with numpy leaves: owned copies,
    read one leaf at a time with the mapping's pages released between."""
    f = SafetensorsFile(path)
    try:
        meta = f.metadata
        if meta.get("format") != FORMAT_TAG:
            raise ValueError(f"{path}: not a {FORMAT_TAG} artifact "
                             f"(format={meta.get('format')!r}); for a dense checkpoint "
                             "use RWKV(quant='q4').load_file, which quantizes it")
        blocks = json.loads(meta["blocks"])

        def arr(name):
            a = np.array(f[name])  # an owned copy off the mapping
            f.release()
            return a

        def q4(fam):
            return Quant4Linear(wp=arr(fam + ".wp"), scale=arr(fam + ".scale"),
                                offset=arr(fam + ".offset"), block=blocks[fam])

        def ln(prefix):
            return LNParams(arr(prefix + ".weight"), arr(prefix + ".bias"))

        params = RWKVParams(
            emb=arr("emb"),
            ln0=ln("ln0"), ln1=ln("ln1"), ln2=ln("ln2"),
            att=AttParams(
                mix_k=arr("att.mix_k"), mix_v=arr("att.mix_v"), mix_r=arr("att.mix_r"),
                key=q4("att.key"), value=q4("att.value"),
                receptance=q4("att.receptance"), output=q4("att.output"),
                decay=arr("att.decay"), bonus=arr("att.bonus"),
            ),
            ffn=FFNParams(
                mix_k=arr("ffn.mix_k"), mix_r=arr("ffn.mix_r"),
                key=q4("ffn.key"), value=q4("ffn.value"), receptance=q4("ffn.receptance"),
            ),
            ln_out=ln("ln_out"),
            head=q4("head"),
            logit_bias=arr("logit_bias") if "logit_bias" in f else None,
        )
        exp = (int(meta["n_layer"]), int(meta["n_embd"]))
        got = (params.n_layer, params.n_embd)
        if got != exp:
            raise ValueError(f"{path}: header says {exp}, tensors say {got}")
        return params
    finally:
        f.close()
