"""RWKV-v4 .pth / .safetensors checkpoints -> params, and the offline
converter to a quantized checkpoint (counterpart of rwkv_tpu/io/convert.py).

`.pth` pickles are read with torch.load(weights_only=True, mmap=True);
`.safetensors` (BlinkDL or HF-transformers names, f32/f16/bf16) through
io/safetensors.py. What comes back is RWKVParams with numpy leaves:

  * load_checkpoint(path)                  dense float32 (also load_pth, the
                                           JAX package's name)
  * load_checkpoint_quantized(path, bits)  u8 QuantLinear (bits=8) or packed
                                           Quant4Linear (bits=4) families,
                                           quantized layer by layer from the
                                           mapped source

As in the reference converter, decay = -exp(time_decay) is baked in, the
mixes and layer norms pass through, and the weights are transposed to the
[in, out] matmul layout. Quantization is ops.quant's float64 numpy
arithmetic, the same as the JAX package's, so both give the same codes.

The converter writes what the JAX one writes, byte for byte:

    python -m rwkv_tpu_torch.io.convert model.pth -o model.bin
    python -m rwkv_tpu_torch.io.convert model.pth --quant q4 -o model.q4.safetensors

`convert` streams a reference-format .bin (io/binfmt.py::write_bin_streaming):
one family quantized at a time from the mapped source, its u8 codes written
unsigned as the file holds them (the engine re-centers them to int8 when it
loads), decay kept in float64. `--quant q4` writes the packed rwkv-tpu-q4/1
artifact (io/q4fmt.py).
"""

from __future__ import annotations

import argparse
import sys

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


load_pth = load_checkpoint


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


# .bin quant-family triplets -> (checkpoint key template, has a layer dim)
_FAMILIES = {
    "km":      ("blocks.{}.att.key.weight", True),
    "vm":      ("blocks.{}.att.value.weight", True),
    "rm":      ("blocks.{}.att.receptance.weight", True),
    "att_out": ("blocks.{}.att.output.weight", True),
    "ffn_k":   ("blocks.{}.ffn.key.weight", True),
    "ffn_v":   ("blocks.{}.ffn.value.weight", True),
    "ffn_r":   ("blocks.{}.ffn.receptance.weight", True),
    "head":    ("head.weight", False),
}
_TRIPLETS = {  # codes name -> (scale name, offset name)
    "km": ("kr", "o1"), "vm": ("vr", "o2"), "rm": ("rr", "o3"),
    "att_out": ("att_out_r", "att_out_o"),
    "ffn_k": ("ffn_kr", "ffn_ko"), "ffn_v": ("ffn_vr", "ffn_vo"),
    "ffn_r": ("ffn_rr", "ffn_ro"), "head": ("head_r", "head_o"),
}


def convert(pth_path: str, out_path: str) -> None:
    """Streaming checkpoint -> reference-format .bin. Tensors are made in
    file order and dropped once written; each weight family is quantized
    layer by layer from the mapped checkpoint, so what the converter keeps
    is one quantized family, beside the float64 temporaries of the matrix
    being quantized (the head is one matrix) and the pages of the mapped
    checkpoint it has read. The bytes are the JAX converter's (and the
    reference converter's): decay = -exp(time_decay) in float64, the empty
    state's pp as float32(-1e30), the scratch slots as arange, the ffn_mix_v
    slot holding time_mix_r, the u8 codes unsigned."""
    print(f"loading {pth_path} (mmap) ...", file=sys.stderr)
    w = _load_weights(pth_path, mmap_ok=True)
    L, E, V = _dims(w, pth_path)
    print(f"model: L={L} E={E} V={V}; converting (streaming) ...", file=sys.stderr)

    def stack_sq(fmt):
        return np.stack([_npf(w[fmt.format(i)]).reshape(-1) for i in range(L)])

    def layernorms():
        # rows 0,1 = ln0 w,b; 4i+2,4i+3 = ln1_i; 4i+4,4i+5 = ln2_i; 4L+2,4L+3 = ln_out
        ln = np.zeros((4 * (L + 1), E), np.float64)
        ln[0], ln[1] = _npf(w["blocks.0.ln0.weight"]), _npf(w["blocks.0.ln0.bias"])
        for i in range(L):
            ln[4 * i + 2] = _npf(w[f"blocks.{i}.ln1.weight"])
            ln[4 * i + 3] = _npf(w[f"blocks.{i}.ln1.bias"])
            ln[4 * i + 4] = _npf(w[f"blocks.{i}.ln2.weight"])
            ln[4 * i + 5] = _npf(w[f"blocks.{i}.ln2.bias"])
        ln[4 * L + 2], ln[4 * L + 3] = _npf(w["ln_out.weight"]), _npf(w["ln_out.bias"])
        return ln

    cache: dict[str, np.ndarray] = {}

    def quantize_family(wname: str) -> None:
        fmt, layered = _FAMILIES[wname]
        sname, oname = _TRIPLETS[wname]
        if layered:
            qs = scs = ofs = None
            for i in range(L):
                q = quantize(_tT(w[fmt.format(i)]))
                if qs is None:
                    qs = np.empty((L,) + q.w.shape, np.uint8)
                    scs = np.empty((L,) + q.scale.shape, np.float32)
                    ofs = np.empty((L,) + q.offset.shape, np.float32)
                qs[i], scs[i], ofs[i] = q.w, q.scale, q.offset
                del q
        else:
            q = quantize(_tT(w[fmt]))
            qs, scs, ofs = q.w, q.scale, q.offset
        cache[wname], cache[sname], cache[oname] = qs, scs, ofs
        r = getattr(w, "release", None)  # a mapped .safetensors drops its pages
        if r is not None:
            r()

    simple = {
        "embed": lambda: _npf(w["emb.weight"]),
        "layernorms": layernorms,
        "mix_k": lambda: stack_sq("blocks.{}.att.time_mix_k"),
        "mix_v": lambda: stack_sq("blocks.{}.att.time_mix_v"),
        "mix_r": lambda: stack_sq("blocks.{}.att.time_mix_r"),
        "ffn_mix_k": lambda: stack_sq("blocks.{}.ffn.time_mix_k"),
        # registry quirk: the ffn_mix_v slot holds time_mix_r
        "ffn_mix_v": lambda: stack_sq("blocks.{}.ffn.time_mix_r"),
        "decay": lambda: -np.exp(stack_sq("blocks.{}.att.time_decay").astype(np.float64)),
        "bonus": lambda: stack_sq("blocks.{}.att.time_first"),
        # float32(-1e30) widened, as the reference converter's default-dtype
        # tensor holds it
        "state_pp": lambda: np.full((L, E), np.float32(-1e30)),
    }

    def get(spec):
        name = spec.name
        if name in cache:
            return cache.pop(name)
        if name in _FAMILIES:
            quantize_family(name)
            return cache.pop(name)
        if name in simple:
            return simple[name]()
        if name.endswith("buffer") or name in ("xbuf", "buffer1", "buffer2", "buffer3",
                                               "buffer4"):
            # scratch slots: readers ignore them; the reference writes arange
            return np.arange(spec.numel(L, E)).reshape(spec.shape(L, E))
        return np.zeros(spec.shape(L, E))  # the empty state

    from rwkv_tpu_torch.io.binfmt import write_bin_streaming

    print(f"writing {out_path} ...", file=sys.stderr)
    write_bin_streaming(out_path, L, E, get)
    print("done", file=sys.stderr)


def _pick_file_gui() -> str | None:
    """A tkinter file dialog for the checkpoint when none is given on the
    command line (the reference converter's fallback). None when tkinter or
    a display is missing."""
    try:
        import tkinter as tk
        from tkinter import filedialog
    except ImportError:
        return None
    try:
        root = tk.Tk()
    except tk.TclError:  # no $DISPLAY
        return None
    root.withdraw()
    path = filedialog.askopenfilename(
        title="Select RWKV-v4 checkpoint",
        filetypes=[("PyTorch checkpoint", "*.pth"),
                   ("safetensors checkpoint", "*.safetensors"), ("All files", "*")])
    root.destroy()
    return path or None


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m rwkv_tpu_torch.io.convert",
        description="Convert RWKV-v4 .pth/.safetensors to a quantized checkpoint")
    p.add_argument("pth", nargs="?", default=None,
                   help="input .pth or .safetensors checkpoint (BlinkDL or HF-transformers "
                        "names; omit to pick it in a file dialog)")
    p.add_argument("-o", "--out", default="model.bin", help="output path")
    p.add_argument("--quant", choices=["q8", "q4"], default="q8",
                   help="q8: reference-format .bin (default). q4: packed 4-bit "
                        ".safetensors artifact (io/q4fmt.py), which RWKV(path) loads "
                        "without the dense source")
    args = p.parse_args(argv)
    if args.pth is None:
        args.pth = _pick_file_gui()
        if args.pth is None:
            p.error("no input checkpoint given and no GUI available")
    if args.quant == "q4":
        from rwkv_tpu_torch.io.q4fmt import save_q4

        if args.out == "model.bin":  # the untouched default: fix the suffix
            args.out = "model.q4.safetensors"
        if not args.out.endswith(".safetensors"):
            p.error("--quant q4 writes a .safetensors artifact; "
                    f"give -o a .safetensors path (got {args.out})")
        save_q4(args.out, load_checkpoint_quantized(args.pth, bits=4))
        print(f"wrote packed q4 artifact {args.out}")
        return
    convert(args.pth, args.out)


if __name__ == "__main__":
    main()
