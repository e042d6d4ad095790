"""Minimal, numpy-only safetensors reader/writer + RWKV name mapping
(the port's own copy of rwkv_tpu/io/safetensors.py).

Most redistributed RWKV-v4 checkpoints ship as .safetensors (native
BlinkDL names, or HF-transformers `RwkvForCausalLM` names); io/convert.py,
io/q4fmt.py and the engine read them through this module. The format is
an 8-byte little-endian header length, a JSON header mapping tensor
name -> {dtype, shape, data_offsets}, then a flat data section, which
mmap + numpy read zero-copy. bf16 payloads are widened to float32 here,
from the raw 16-bit words, so no bfloat16 numpy dtype is needed.

Not a vendored library: ~100 lines implementing the published format
spec (huggingface.co/docs/safetensors), plus the RWKV-v4 HF->BlinkDL
key translation table.
"""

from __future__ import annotations

import json
import mmap
import os
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np

# safetensors dtype tag -> numpy dtype string (BF16 handled specially)
_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "|i1",
    "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "|u1",
    "BOOL": "|b1",
}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """uint16 bf16 payload -> float32 (shift into the high mantissa)."""
    return (raw.astype(np.uint32) << 16).view(np.float32)


class SafetensorsFile(Mapping):
    """Read-only mmap'd view of one .safetensors file.

    `f[name]` returns a numpy array: zero-copy for F32/I8/U8/... dtypes,
    converted to float32 for BF16/F16 (checkpoints are commonly bf16;
    the converter quantizes from float anyway).
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        if len(self._mm) < 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (hlen,) = np.frombuffer(self._mm[:8], "<u8")
        hlen = int(hlen)
        if hlen <= 0 or 8 + hlen > len(self._mm):
            raise ValueError(f"{path}: bad safetensors header length {hlen}")
        try:
            header = json.loads(self._mm[8:8 + hlen].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: bad safetensors header: {e}") from e
        self.metadata: Dict[str, str] = header.pop("__metadata__", {}) or {}
        self._base = 8 + hlen
        data_len = len(self._mm) - self._base
        self._entries: Dict[str, Tuple[str, tuple, int, int]] = {}
        for name, ent in header.items():
            dt, shape = ent["dtype"], tuple(ent["shape"])
            lo, hi = ent["data_offsets"]
            if not (0 <= lo <= hi <= data_len):
                raise ValueError(f"{path}: {name}: offsets {lo}:{hi} outside "
                                 f"data section of {data_len} bytes")
            self._entries[name] = (dt, shape, lo, hi)

    # Mapping interface -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __contains__(self, name) -> bool:
        return name in self._entries

    def __getitem__(self, name: str) -> np.ndarray:
        dt, shape, lo, hi = self._entries[name]
        # np.frombuffer over the mmap itself is the zero-copy path; a
        # mmap slice (self._mm[a:b]) would COPY the tensor bytes.
        if dt == "BF16":
            raw = np.frombuffer(self._mm, "<u2", count=(hi - lo) // 2,
                                offset=self._base + lo)
            return _bf16_to_f32(raw).reshape(shape)
        if dt not in _DTYPES:
            raise ValueError(f"{self.path}: {name}: unsupported dtype {dt}")
        np_dt = np.dtype(_DTYPES[dt])
        arr = np.frombuffer(self._mm, np_dt, count=(hi - lo) // np_dt.itemsize,
                            offset=self._base + lo).reshape(shape)
        if dt == "F16":
            return arr.astype(np.float32)
        return arr

    def dtype_of(self, name: str) -> str:
        return self._entries[name][0]

    def release(self) -> None:
        """Drop this mapping's resident pages (madvise MADV_DONTNEED).

        Existing numpy views stay valid — the mapping is read-only and
        file-backed, so dropped pages simply refault from page cache /
        disk on next access. Streaming consumers call this between
        passes so a multi-GB checkpoint doesn't accumulate in host RSS
        (same discipline as binfmt._take_tensor)."""
        if hasattr(self._mm, "madvise") and hasattr(mmap, "MADV_DONTNEED"):
            self._mm.madvise(mmap.MADV_DONTNEED)

    def close(self) -> None:
        self._mm.close()
        self._f.close()


def _np_dtype_tag(a: np.ndarray) -> str:
    if a.dtype == np.float32:
        return "F32"
    if a.dtype == np.float64:
        return "F64"
    if a.dtype == np.float16:
        return "F16"
    if a.dtype == np.int8:
        return "I8"
    if a.dtype == np.uint8:
        return "U8"
    if a.dtype == np.int32:
        return "I32"
    if a.dtype == np.int64:
        return "I64"
    if a.dtype.name == "bfloat16":   # ml_dtypes, where installed
        return "BF16"
    raise ValueError(f"unsupported dtype for safetensors write: {a.dtype}")


def write_safetensors(path: str, tensors: Mapping[str, np.ndarray],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write a dict of numpy arrays as one .safetensors file."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    off = 0
    blobs = []
    for name, a in tensors.items():
        a = np.ascontiguousarray(a)
        tag = _np_dtype_tag(a)
        raw = a.view(np.uint16) if tag == "BF16" else a
        blobs.append(raw.tobytes())
        header[name] = {"dtype": tag, "shape": list(a.shape),
                       "data_offsets": [off, off + len(blobs[-1])]}
        off += len(blobs[-1])
    hjs = json.dumps(header, separators=(",", ":")).encode("utf-8")
    with open(path, "wb") as f:
        f.write(np.uint64(len(hjs)).tobytes())
        f.write(hjs)
        for b in blobs:
            f.write(b)


# ---------------------------------------------------------------------------
# RWKV-v4 key translation: HF-transformers `RwkvForCausalLM` state dict ->
# the BlinkDL names the converter pipeline (io/convert.py) speaks.
# ---------------------------------------------------------------------------

_HF_FIXED = {
    "emb.weight": "rwkv.embeddings.weight",
    "blocks.0.ln0.weight": "rwkv.blocks.0.pre_ln.weight",
    "blocks.0.ln0.bias": "rwkv.blocks.0.pre_ln.bias",
    "ln_out.weight": "rwkv.ln_out.weight",
    "ln_out.bias": "rwkv.ln_out.bias",
    "head.weight": "head.weight",
}
_HF_BLOCK = {
    "ln1.weight": "ln1.weight", "ln1.bias": "ln1.bias",
    "ln2.weight": "ln2.weight", "ln2.bias": "ln2.bias",
    "att.time_mix_k": "attention.time_mix_key",
    "att.time_mix_v": "attention.time_mix_value",
    "att.time_mix_r": "attention.time_mix_receptance",
    "att.time_decay": "attention.time_decay",
    "att.time_first": "attention.time_first",
    "att.key.weight": "attention.key.weight",
    "att.value.weight": "attention.value.weight",
    "att.receptance.weight": "attention.receptance.weight",
    "att.output.weight": "attention.output.weight",
    "ffn.time_mix_k": "feed_forward.time_mix_key",
    "ffn.time_mix_r": "feed_forward.time_mix_receptance",
    "ffn.key.weight": "feed_forward.key.weight",
    "ffn.value.weight": "feed_forward.value.weight",
    "ffn.receptance.weight": "feed_forward.receptance.weight",
}


def is_hf_rwkv(keys) -> bool:
    return "rwkv.embeddings.weight" in keys


def hf_key(blinkdl_name: str) -> str:
    """BlinkDL-style key -> HF-transformers key (raises on unknown)."""
    if blinkdl_name in _HF_FIXED:
        return _HF_FIXED[blinkdl_name]
    if blinkdl_name.startswith("blocks."):
        _, i, rest = blinkdl_name.split(".", 2)
        if rest in _HF_BLOCK:
            return f"rwkv.blocks.{i}.{_HF_BLOCK[rest]}"
    raise KeyError(blinkdl_name)


class CheckpointView(Mapping):
    """BlinkDL-keyed float32 view over a SafetensorsFile (native BlinkDL
    names pass through; HF-transformers names are translated)."""

    def __init__(self, st: SafetensorsFile):
        self._st = st
        self._hf = is_hf_rwkv(st)
        if self._hf:
            self._keys = []
            for k in st:
                for b, h in _HF_FIXED.items():
                    if k == h and b not in self._keys:
                        self._keys.append(b)
                if k.startswith("rwkv.blocks."):
                    _, _, i, rest = k.split(".", 3)
                    for b, h in _HF_BLOCK.items():
                        if rest == h:
                            self._keys.append(f"blocks.{i}.{b}")
        else:
            self._keys = list(st)

    def __len__(self) -> int:
        return len(self._keys)

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __contains__(self, name) -> bool:
        try:
            return (hf_key(name) if self._hf else name) in self._st
        except KeyError:
            return False

    def __getitem__(self, name: str) -> np.ndarray:
        a = self._st[hf_key(name) if self._hf else name]
        if a.dtype != np.float32:
            a = a.astype(np.float32)
        return a

    def release(self) -> None:
        self._st.release()


def open_checkpoint(path: str) -> CheckpointView:
    """Open a .safetensors RWKV-v4 checkpoint (BlinkDL or HF naming) as a
    BlinkDL-keyed float32 mapping."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return CheckpointView(SafetensorsFile(path))
