"""The reference checkpoint schema: 46 named tensors in fixed order.

This mirrors the reference's implicit "model schema" — the `names[46]`,
`types[46]` and `getSize()` tables in include/rwkv/rwkv/rwkv.h:10-128 and the
save order of converter/cpp_save_tensor.cpp:27-93 — so that .bin files are
interchangeable between the reference engine and this framework.

Size formulas use a = n_layer, b = n_embd, V = 50277 (hardcoded in the
reference). Dtypes: 'd' float64, 'f' float32, 'u1' uint8.

Quirks preserved for compatibility:
  * slot 28 is *named* ffn_mix_v but holds ffn.time_mix_r (the converter
    passes mixffnr there, convert_model.py:160-161).
  * slots 0, 8-11, 38-40 are scratch buffers whose stored content is
    meaningless (the converter writes torch.arange); readers ignore them.
  * the u8 matrices are stored transposed to [in, out] ("x @ W" layout) with
    per-input-channel scale ("ranges") and offset ("zero point") vectors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

VOCAB = 50277


class TensorSpec(NamedTuple):
    name: str
    dtype: str                      # numpy dtype string: 'f8', 'f4', 'u1'
    numel: Callable[[int, int], int]  # (n_layer, n_embd) -> element count
    shape: Callable[[int, int], tuple]  # logical shape for readers


def _spec(name, dtype, shape_fn):
    def numel(a, b):
        n = 1
        for s in shape_fn(a, b):
            n *= s
        return n

    return TensorSpec(name, dtype, numel, shape_fn)


# Order and sizes are the reference registry (rwkv.h:10-56, :84, :126).
REGISTRY: list[TensorSpec] = [
    _spec("xbuf",         "f8", lambda a, b: (b,)),
    _spec("embed",        "f4", lambda a, b: (VOCAB, b)),
    _spec("layernorms",   "f8", lambda a, b: (4 * (a + 1), b)),
    _spec("state_xy",     "f8", lambda a, b: (a, b)),
    _spec("state_aa",     "f8", lambda a, b: (a, b)),
    _spec("state_bb",     "f8", lambda a, b: (a, b)),
    _spec("state_pp",     "f8", lambda a, b: (a, b)),
    _spec("state_dd",     "f8", lambda a, b: (a, b)),
    _spec("buffer1",      "f8", lambda a, b: (b,)),
    _spec("buffer2",      "f4", lambda a, b: (VOCAB,)),
    _spec("buffer3",      "f4", lambda a, b: (b,)),
    _spec("buffer4",      "f4", lambda a, b: (b,)),
    _spec("mix_k",        "f8", lambda a, b: (a, b)),
    _spec("mix_v",        "f8", lambda a, b: (a, b)),
    _spec("mix_r",        "f8", lambda a, b: (a, b)),
    _spec("km",           "u1", lambda a, b: (a, b, b)),
    _spec("vm",           "u1", lambda a, b: (a, b, b)),
    _spec("rm",           "u1", lambda a, b: (a, b, b)),
    _spec("kr",           "f4", lambda a, b: (a, b)),
    _spec("vr",           "f4", lambda a, b: (a, b)),
    _spec("rr",           "f4", lambda a, b: (a, b)),
    _spec("o1",           "f4", lambda a, b: (a, b)),
    _spec("o2",           "f4", lambda a, b: (a, b)),
    _spec("o3",           "f4", lambda a, b: (a, b)),
    _spec("att_out",      "u1", lambda a, b: (a, b, b)),
    _spec("att_out_r",    "f4", lambda a, b: (a, b)),
    _spec("att_out_o",    "f4", lambda a, b: (a, b)),
    _spec("ffn_mix_k",    "f8", lambda a, b: (a, b)),
    _spec("ffn_mix_v",    "f8", lambda a, b: (a, b)),   # actually time_mix_r!
    _spec("ffn_k",        "u1", lambda a, b: (a, b, 4 * b)),
    _spec("ffn_v",        "u1", lambda a, b: (a, 4 * b, b)),
    _spec("ffn_r",        "u1", lambda a, b: (a, b, b)),
    _spec("ffn_kr",       "f4", lambda a, b: (a, b)),
    _spec("ffn_vr",       "f4", lambda a, b: (a, 4 * b)),
    _spec("ffn_rr",       "f4", lambda a, b: (a, b)),
    _spec("ffn_ko",       "f4", lambda a, b: (a, b)),
    _spec("ffn_vo",       "f4", lambda a, b: (a, 4 * b)),
    _spec("ffn_ro",       "f4", lambda a, b: (a, b)),
    _spec("ffn_k_buffer", "f8", lambda a, b: (b,)),
    _spec("ffn_v_buffer", "f8", lambda a, b: (b,)),
    _spec("ffn_r_buffer", "f4", lambda a, b: (4 * b,)),
    _spec("decay",        "f8", lambda a, b: (a, b)),
    _spec("bonus",        "f8", lambda a, b: (a, b)),
    _spec("head",         "u1", lambda a, b: (b, VOCAB)),
    _spec("head_r",       "f4", lambda a, b: (b,)),
    _spec("head_o",       "f4", lambda a, b: (b,)),
]

INDEX = {spec.name: i for i, spec in enumerate(REGISTRY)}

# Slots whose stored contents are scratch garbage (converter writes arange).
SCRATCH = {"xbuf", "buffer1", "buffer2", "buffer3", "buffer4",
           "ffn_k_buffer", "ffn_v_buffer", "ffn_r_buffer"}


def header_nbytes() -> int:
    return 16  # two little-endian int64: n_layer, n_embd


def tensor_nbytes(spec: TensorSpec, a: int, b: int) -> int:
    itemsize = {"f8": 8, "f4": 4, "u1": 1}[spec.dtype]
    return spec.numel(a, b) * itemsize


def file_layout(a: int, b: int) -> list[tuple[str, int, int]]:
    """[(name, byte_offset, byte_length)] for a .bin with given dims."""
    out = []
    off = header_nbytes()
    for spec in REGISTRY:
        n = tensor_nbytes(spec, a, b)
        out.append((spec.name, off, n))
        off += n
    return out
