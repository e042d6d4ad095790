"""RWKV-v4 .pth / .safetensors checkpoints -> params (counterpart of
rwkv_tpu/io/convert.py).

`.pth` pickles are read with torch.load(weights_only=True, mmap=True);
`.safetensors` (BlinkDL or HF-transformers names, f32/f16/bf16) through
io/safetensors.py. What comes back is RWKVParams with numpy leaves:

  * load_checkpoint(path)                  dense float32 (the JAX load_pth)
  * load_checkpoint_quantized(path, bits)  u8 QuantLinear (bits=8) or packed
                                           Quant4Linear (bits=4) families,
                                           quantized layer by layer from the
                                           mapped source

As in the reference converter, decay = -exp(time_decay) is baked in, the
mixes and layer norms pass through, and the weights are transposed to the
[in, out] matmul layout. Quantization is ops.quant's float64 numpy
arithmetic, the same as the JAX package's, so both give the same codes.
The .bin writer (`convert`) and its command line are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.rwkv4 import (
    AttParams,
    FFNParams,
    LNParams,
    RWKVParams,
    q4_pack_block,
)
from rwkv_tpu_torch.ops.quant import Quant4Linear, QuantLinear, quantize, quantize4

REQUIRED_KEYS = (
    "emb.weight",
    "ln_out.weight",
    "ln_out.bias",
    "blocks.0.ln0.weight",
    "blocks.0.ln0.bias",
    "head.weight",
)


def _npf(t) -> np.ndarray:
    """Tensor (torch or numpy) -> float32 ndarray."""
    if isinstance(t, np.ndarray):
        return np.asarray(t, dtype=np.float32)
    return np.asarray(t.float().numpy(), dtype=np.float32)


def _tT(t) -> np.ndarray:
    """[out, in] weight (torch or numpy) -> contiguous float32 [in, out]."""
    if isinstance(t, np.ndarray):
        return np.ascontiguousarray(np.asarray(t, np.float32).T)
    return t.float().t().contiguous().numpy()


def _load_weights(path: str, mmap_ok: bool = False):
    """A BlinkDL-keyed mapping over a checkpoint: .safetensors through the
    numpy reader (HF names translated), anything else as a torch pickle."""
    if path.endswith(".safetensors"):
        from rwkv_tpu_torch.io.safetensors import open_checkpoint

        return open_checkpoint(path)
    if mmap_ok:
        try:
            return torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        except (TypeError, RuntimeError):  # pre-zipfile pickles cannot be mapped
            pass
    return torch.load(path, map_location="cpu", weights_only=True)


def _dims(w, path: str) -> tuple[int, int, int]:
    missing = [k for k in REQUIRED_KEYS if k not in w]
    if missing or "blocks.0.att.key.weight" not in w:
        raise ValueError(f"{path}: not an RWKV-v4 checkpoint; missing {missing}")
    L = sum(1 for k in w if "blocks" in k and "ln1.bias" in k)
    return L, w["blocks.0.att.key.weight"].shape[1], w["emb.weight"].shape[0]


def checkpoint_dims(path: str) -> tuple[int, int, int]:
    """(n_layer, n_embd, vocab) from the tensor shapes alone."""
    return _dims(_load_weights(path, mmap_ok=True), path)


def _read(path: str, fam, mmap_ok: bool) -> RWKVParams:
    """RWKVParams from a checkpoint; fam(w, L, template, row_tiled) builds
    each of the 7 per-layer matrix families from its key template, and
    fam(w, L, name, None) the head."""
    w = _load_weights(path, mmap_ok=mmap_ok)
    L, E, vocab = _dims(w, path)

    def stack(fmt, transform=_npf):
        return np.stack([transform(w[fmt.format(i)]) for i in range(L)])

    def stack_sq(fmt):
        return stack(fmt, lambda t: _npf(t).reshape(-1))

    params = RWKVParams(
        emb=_npf(w["emb.weight"]),
        ln0=LNParams(_npf(w["blocks.0.ln0.weight"]), _npf(w["blocks.0.ln0.bias"])),
        ln1=LNParams(stack("blocks.{}.ln1.weight"), stack("blocks.{}.ln1.bias")),
        ln2=LNParams(stack("blocks.{}.ln2.weight"), stack("blocks.{}.ln2.bias")),
        att=AttParams(
            mix_k=stack_sq("blocks.{}.att.time_mix_k"),
            mix_v=stack_sq("blocks.{}.att.time_mix_v"),
            mix_r=stack_sq("blocks.{}.att.time_mix_r"),
            key=fam(w, L, "blocks.{}.att.key.weight", False),
            value=fam(w, L, "blocks.{}.att.value.weight", False),
            receptance=fam(w, L, "blocks.{}.att.receptance.weight", False),
            output=fam(w, L, "blocks.{}.att.output.weight", True),
            decay=-np.exp(stack_sq("blocks.{}.att.time_decay").astype(np.float64)
                          ).astype(np.float32),
            bonus=stack_sq("blocks.{}.att.time_first"),
        ),
        ffn=FFNParams(
            mix_k=stack_sq("blocks.{}.ffn.time_mix_k"),
            mix_r=stack_sq("blocks.{}.ffn.time_mix_r"),
            key=fam(w, L, "blocks.{}.ffn.key.weight", False),
            value=fam(w, L, "blocks.{}.ffn.value.weight", True),
            receptance=fam(w, L, "blocks.{}.ffn.receptance.weight", False),
        ),
        ln_out=LNParams(_npf(w["ln_out.weight"]), _npf(w["ln_out.bias"])),
        head=fam(w, L, "head.weight", None),
    )
    if params.config != RWKVConfig(n_layer=L, n_embd=E, vocab_size=vocab):
        raise ValueError(f"{path}: inconsistent tensor shapes")
    return params


def load_checkpoint(path: str) -> RWKVParams:
    """Dense float32 RWKVParams from a BlinkDL RWKV-v4 .pth or .safetensors."""

    def dense(w, L, fmt, row_tiled):
        if row_tiled is None:
            return _tT(w[fmt])
        first = _tT(w[fmt.format(0)])
        out = np.empty((L,) + first.shape, np.float32)
        out[0] = first
        for i in range(1, L):
            out[i] = _tT(w[fmt.format(i)])
        return out

    return _read(path, dense, mmap_ok=False)


def load_checkpoint_quantized(path: str, bits: int = 8,
                              q4_tile: int | None = None) -> RWKVParams:
    """Quantized RWKVParams straight from a checkpoint, quantizing the 8
    matrix families layer by layer from the mapped source, so host memory
    holds the quantized params plus one dense layer.

    bits=4: packed Quant4Linear families; the row-tiled ones (att.output,
    ffn.value) pair rows within blocks of q4_tile (default
    q4_pack_block(E), or E where E is not a multiple of 128), the others
    globally."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if bits == 4 and q4_tile is None:
        _, E, _ = checkpoint_dims(path)
        q4_tile = q4_pack_block(E) if E % 128 == 0 else E

    def release(w):
        # drop the source mapping's resident pages between families
        # (safetensors only; a mapped torch pickle has no such hook)
        r = getattr(w, "release", None)
        if r is not None:
            r()

    def quant(w, L, fmt, row_tiled):
        if row_tiled is None:
            dense = _tT(w[fmt])
            return quantize4(dense) if bits == 4 else quantize(dense)
        block = q4_tile if row_tiled else None
        parts = []
        for i in range(L):
            dense = _tT(w[fmt.format(i)])
            parts.append(quantize4(dense, block=block) if bits == 4 else quantize(dense))
        release(w)
        if bits == 4:
            return Quant4Linear(np.stack([q.wp for q in parts]),
                                np.stack([q.scale for q in parts]),
                                np.stack([q.offset for q in parts]), block=block)
        return QuantLinear(np.stack([q.w for q in parts]), np.stack([q.scale for q in parts]),
                           np.stack([q.offset for q in parts]))

    return _read(path, quant, mmap_ok=True)
