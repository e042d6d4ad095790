"""Reference-format `.bin` checkpoints (counterpart of rwkv_tpu/io/binfmt.py).

Format: two little-endian int64 (n_layer, n_embd), then the 46 registry
tensors raw, in order (io/registry.py). Reading streams: each tensor is
memory-mapped, copied out once, its mapping closed, and the copy moved to
the device before the next tensor is touched, so host memory holds about
one tensor at a time. Writing: `write_bin` from params in memory,
`write_bin_streaming` from a provider of one tensor at a time (the
converter, io/convert.py).
"""

from __future__ import annotations

import numpy as np
import torch

from rwkv_tpu_torch.io.registry import REGISTRY, VOCAB, file_layout
from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.rwkv4 import AttParams, FFNParams, LNParams, RWKVParams
from rwkv_tpu_torch.ops.quant import QuantLinear


def read_header(path: str) -> RWKVConfig:
    with open(path, "rb") as f:
        hdr = np.frombuffer(f.read(16), dtype="<i8")
    if hdr.shape != (2,) or hdr[0] <= 0 or hdr[1] <= 0 or hdr[0] > 1024:
        raise ValueError(f"{path}: not a rwkv .bin file (header {hdr!r})")
    return RWKVConfig(n_layer=int(hdr[0]), n_embd=int(hdr[1]), vocab_size=VOCAB)


def _take_tensor(path: str, layout: dict, name: str, dtype=None) -> np.ndarray:
    """Read ONE registry tensor into an owned host array, then unmap."""
    off, shape, sdtype = layout[name]
    mm = np.memmap(path, dtype="<" + sdtype, mode="r", offset=off, shape=shape)
    arr = mm.astype(dtype) if dtype is not None else np.array(mm)
    raw = mm._mmap
    del mm
    raw.close()
    return arr


def read_bin(path: str, device, *, put=None, pad_vocab_to: int | None = None,
             signed: bool = False) -> RWKVParams:
    """Load a .bin into RWKVParams on `device`.

    signed=True re-centers each u8 family to int8 on the host copy before
    upload (XOR 0x80; offsets absorb +128*scale), so the device never holds
    both. pad_vocab_to pads emb rows / head columns up to that multiple and
    adds the -1e9 logit_bias for the padding.

    put(name, host_array) places each tensor instead of a plain copy to
    `device` (parallel/sharding.py::make_put cuts it into its tensor-parallel
    shards); names are the registry's (io/registry.py), plus "logit_bias",
    "ln0.w", "ln0.b", "ln1.w", ..., "ln_out.b"."""
    cfg = read_header(path)
    a, b = cfg.n_layer, cfg.n_embd
    layout = {name: (off, spec.shape(a, b), spec.dtype)
              for (name, off, _), spec in zip(file_layout(a, b), REGISTRY)}

    vpad = 0
    if pad_vocab_to:
        vpad = ((VOCAB + pad_vocab_to - 1) // pad_vocab_to) * pad_vocab_to - VOCAB

    if put is None:
        def put(name, arr):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    def take(name, dtype=None):
        return _take_tensor(path, layout, name, dtype)

    def f32(name):
        return put(name, take(name, np.float32))

    def qlin(wname, rname, oname) -> QuantLinear:
        w = take(wname)
        if wname == "head" and vpad:
            w = np.pad(w, ((0, 0), (0, vpad)))
        if signed:
            w ^= 0x80            # in place on the owned copy; pad bytes
            w = w.view(np.int8)  # 0x00 -> -128, masked by logit_bias
        dev = put(wname, w)
        del w
        scale = take(rname, np.float32)
        offset = take(oname, np.float32)
        if signed:
            offset += np.float32(128.0) * scale
        return QuantLinear(w=dev, scale=put(rname, scale), offset=put(oname, offset))

    # rows 0,1 = ln0 w,b; 4i+2,4i+3 = ln1_i; 4i+4,4i+5 = ln2_i;
    # 4L+2,4L+3 = ln_out
    ln = take("layernorms", np.float32)
    L = cfg.n_layer
    idx = np.arange(L)

    emb = take("embed", np.float32)
    logit_bias = None
    if vpad:
        emb = np.pad(emb, ((0, vpad), (0, 0)))
        bias = np.zeros((VOCAB + vpad,), np.float32)
        bias[VOCAB:] = -1e9
        logit_bias = put("logit_bias", bias)
    emb_dev = put("embed", emb)
    del emb

    return RWKVParams(
        emb=emb_dev,
        ln0=LNParams(put("ln0.w", ln[0]), put("ln0.b", ln[1])),
        ln1=LNParams(put("ln1.w", ln[4 * idx + 2]), put("ln1.b", ln[4 * idx + 3])),
        ln2=LNParams(put("ln2.w", ln[4 * idx + 4]), put("ln2.b", ln[4 * idx + 5])),
        att=AttParams(
            mix_k=f32("mix_k"), mix_v=f32("mix_v"), mix_r=f32("mix_r"),
            key=qlin("km", "kr", "o1"),
            value=qlin("vm", "vr", "o2"),
            receptance=qlin("rm", "rr", "o3"),
            output=qlin("att_out", "att_out_r", "att_out_o"),
            decay=f32("decay"), bonus=f32("bonus"),
        ),
        ffn=FFNParams(
            mix_k=f32("ffn_mix_k"),
            mix_r=f32("ffn_mix_v"),  # registry quirk: slot holds time_mix_r
            key=qlin("ffn_k", "ffn_kr", "ffn_ko"),
            value=qlin("ffn_v", "ffn_vr", "ffn_vo"),
            receptance=qlin("ffn_r", "ffn_rr", "ffn_ro"),
        ),
        ln_out=LNParams(put("ln_out.w", ln[4 * L + 2]), put("ln_out.b", ln[4 * L + 3])),
        head=qlin("head", "head_r", "head_o"),
        logit_bias=logit_bias,
    )


def _host(x, dt):
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype=dt)


def write_bin(path: str, params: RWKVParams) -> None:
    """Write u8-quantized RWKVParams (vocab >= 50277; numpy or torch leaves)
    as a reference-format .bin. Vocab padding is stripped back to 50277."""
    cfg = params.config
    if cfg.vocab_size < VOCAB:
        raise ValueError(f".bin format requires vocab {VOCAB}, got {cfg.vocab_size}")
    lins = [params.att.key, params.att.value, params.att.receptance,
            params.att.output, params.ffn.key, params.ffn.value,
            params.ffn.receptance, params.head]
    for lin in lins:
        if not isinstance(lin, QuantLinear):
            raise ValueError("write_bin requires quantized params")
        if str(lin.w.dtype) not in ("uint8", "torch.uint8"):
            raise TypeError(f"write_bin stores u8 codes; got {lin.w.dtype} "
                            "(the file holds the unsigned form)")
    a, b = cfg.n_layer, cfg.n_embd
    h = _host

    ln = np.zeros((4 * (a + 1), b), dtype="<f8")
    ln[0], ln[1] = h(params.ln0.weight, "f8"), h(params.ln0.bias, "f8")
    idx = np.arange(a)
    ln[4 * idx + 2] = h(params.ln1.weight, "f8")
    ln[4 * idx + 3] = h(params.ln1.bias, "f8")
    ln[4 * idx + 4] = h(params.ln2.weight, "f8")
    ln[4 * idx + 5] = h(params.ln2.bias, "f8")
    ln[4 * a + 2], ln[4 * a + 3] = h(params.ln_out.weight, "f8"), h(params.ln_out.bias, "f8")

    empty = np.zeros((a, b), dtype="<f8")
    # f32(-1e30) widened, as the reference converter stores it
    neg = np.full((a, b), np.float32(-1e30), dtype="<f8")
    att, ffn = params.att, params.ffn
    data = {
        # scratch slots: readers ignore them; the reference writes arange
        "xbuf": np.arange(b, dtype="<f8"),
        "embed": h(params.emb, "<f4")[:VOCAB],
        "layernorms": ln,
        "state_xy": empty, "state_aa": empty, "state_bb": empty,
        "state_pp": neg, "state_dd": empty,
        "buffer1": np.arange(b, dtype="<f8"),
        "buffer2": np.arange(VOCAB, dtype="<f4"),
        "buffer3": np.arange(b, dtype="<f4"),
        "buffer4": np.arange(b, dtype="<f4"),
        "mix_k": h(att.mix_k, "<f8"), "mix_v": h(att.mix_v, "<f8"),
        "mix_r": h(att.mix_r, "<f8"),
        "km": h(att.key.w, "u1"), "vm": h(att.value.w, "u1"),
        "rm": h(att.receptance.w, "u1"),
        "kr": h(att.key.scale, "<f4"), "vr": h(att.value.scale, "<f4"),
        "rr": h(att.receptance.scale, "<f4"),
        "o1": h(att.key.offset, "<f4"), "o2": h(att.value.offset, "<f4"),
        "o3": h(att.receptance.offset, "<f4"),
        "att_out": h(att.output.w, "u1"),
        "att_out_r": h(att.output.scale, "<f4"),
        "att_out_o": h(att.output.offset, "<f4"),
        "ffn_mix_k": h(ffn.mix_k, "<f8"),
        "ffn_mix_v": h(ffn.mix_r, "<f8"),  # quirk: slot holds mix_r
        "ffn_k": h(ffn.key.w, "u1"), "ffn_v": h(ffn.value.w, "u1"),
        "ffn_r": h(ffn.receptance.w, "u1"),
        "ffn_kr": h(ffn.key.scale, "<f4"), "ffn_vr": h(ffn.value.scale, "<f4"),
        "ffn_rr": h(ffn.receptance.scale, "<f4"),
        "ffn_ko": h(ffn.key.offset, "<f4"), "ffn_vo": h(ffn.value.offset, "<f4"),
        "ffn_ro": h(ffn.receptance.offset, "<f4"),
        "ffn_k_buffer": np.arange(b, dtype="<f8"),
        "ffn_v_buffer": np.arange(b, dtype="<f8"),
        "ffn_r_buffer": np.arange(4 * b, dtype="<f4"),
        "decay": h(att.decay, "<f8"), "bonus": h(att.bonus, "<f8"),
        "head": h(params.head.w, "u1")[:, :VOCAB],
        "head_r": h(params.head.scale, "<f4"),
        "head_o": h(params.head.offset, "<f4"),
    }

    with open(path, "wb") as f:
        f.write(np.asarray([a, b], dtype="<i8").tobytes())
        for spec in REGISTRY:
            arr = data[spec.name]
            expected = spec.shape(a, b)
            if tuple(arr.shape) != tuple(expected):
                raise ValueError(f"{spec.name}: shape {arr.shape} != {expected}")
            f.write(np.ascontiguousarray(arr).tobytes())


def write_bin_streaming(path: str, n_layer: int, n_embd: int, get) -> None:
    """Write a .bin one tensor at a time: `get(spec)` returns the array for
    each REGISTRY entry in file order (io/registry.py), which is checked
    against the spec's shape and cast to its dtype, written, and dropped
    before the next is asked for: the writer holds one tensor at a time,
    beside whatever the provider keeps."""
    a, b = n_layer, n_embd
    with open(path, "wb") as f:
        f.write(np.asarray([a, b], dtype="<i8").tobytes())
        for spec in REGISTRY:
            dt = "u1" if spec.dtype == "u1" else "<" + spec.dtype
            arr = np.ascontiguousarray(np.asarray(get(spec)), dtype=dt)
            expected = spec.shape(a, b)
            if tuple(arr.shape) != tuple(expected):
                raise ValueError(f"{spec.name}: shape {arr.shape} != {expected}")
            f.write(arr.tobytes())
            del arr
