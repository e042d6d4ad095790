"""ctypes bindings for the port's native C++ BPE tokenizer (counterpart of
rwkv_tpu/tokenizer/native.py).

The source is rwkv_tpu_torch/csrc/tokenizer.cpp: the JAX package's
native/tokenizer.cpp with its decode fixed for the vocab's added tokens
(ids 50254..50276, runs of spaces), so that every id decodes to the bytes the
Python tokenizer gives. It is compiled at first use with g++, as
ops/cuda/_build.py compiles the kernels with nvcc:

    g++ -O2 -std=c++17 -fPIC -shared -o _build/librwkv_tok-<digest>.so csrc/tokenizer.cpp

into rwkv_tpu_torch/_build/ (listed in .gitignore), named by a digest of the
source and flags. Each build writes a temp name of its own and renames it
into place, so concurrent builds (test workers, server processes) leave one
whole library. `python -m rwkv_tpu_torch.tokenizer.native build` builds it.

Same surface as the Python BPETokenizer (encode, decode, decode_bytes,
vocab_size). `load_best` takes the native tokenizer when it builds and
loads, else the Python one: it is a host tokenizer, so the fallback changes
the speed of encode, not any result. NativeBPETokenizer.load raises instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "tokenizer.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


def cxx() -> str:
    """The C++ compiler: $CXX, else g++ on $PATH."""
    found = shutil.which(os.environ.get("CXX") or "g++")
    if not found:
        raise RuntimeError("no C++ compiler (g++ or $CXX): the native tokenizer cannot be built")
    return found


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librwkv_tok-{h.hexdigest()[:12]}.so"


def _find_so() -> str | None:
    """The built library for the current source, or None."""
    p = lib_path()
    return str(p) if p.exists() else None


def build() -> str:
    """Compile csrc/tokenizer.cpp unless it is built; returns the library's
    path. Raises if the compiler is missing or fails."""
    out = lib_path()
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        r = subprocess.run([cxx(), *FLAGS, "-o", tmp, str(SOURCE)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"native tokenizer build failed (exit {r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(out)


class NativeBPETokenizer:
    """Drop-in for tokenizer.bpe.BPETokenizer backed by librwkv_tok."""

    def __init__(self, so_path: str, vocab_file: str, merges_file: str):
        lib = ctypes.CDLL(so_path)
        lib.rwkv_tok_load.restype = ctypes.c_void_p
        lib.rwkv_tok_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.rwkv_tok_vocab_size.restype = ctypes.c_int
        lib.rwkv_tok_vocab_size.argtypes = [ctypes.c_void_p]
        lib.rwkv_tok_encode.restype = ctypes.c_long
        lib.rwkv_tok_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
        lib.rwkv_tok_decode.restype = ctypes.c_long
        lib.rwkv_tok_decode.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                                        ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
        lib.rwkv_tok_free.restype = None
        lib.rwkv_tok_free.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = lib.rwkv_tok_load(vocab_file.encode(), merges_file.encode())
        if not self._h:
            raise RuntimeError(f"native tokenizer failed to load {vocab_file}")
        # encode fills the library's merge cache: one caller at a time (the
        # HTTP server tokenizes on its handler threads)
        self._lock = threading.Lock()

    @classmethod
    def load(cls, vocab_dir: str | None = None) -> "NativeBPETokenizer":
        """vocab.json + merges.txt from vocab_dir (or $RWKV_TPU_VOCAB), else
        the bundled vocab written out by assets.ensure_files()."""
        vocab_dir = vocab_dir or os.environ.get("RWKV_TPU_VOCAB")
        if not vocab_dir:
            from rwkv_tpu_torch.tokenizer import assets

            vocab_dir = assets.ensure_files()
        return cls(build(), os.path.join(vocab_dir, "vocab.json"),
                   os.path.join(vocab_dir, "merges.txt"))

    @property
    def vocab_size(self) -> int:
        return self._lib.rwkv_tok_vocab_size(self._h)

    def encode(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        with self._lock:
            n = self._lib.rwkv_tok_encode(self._h, data, None, 0)
            if n <= 0:
                return []
            buf = (ctypes.c_int32 * n)()
            self._lib.rwkv_tok_encode(self._h, data, buf, n)
        return list(buf)

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        arr = [int(i) for i in ids]
        if not arr:
            return b""
        cbuf = (ctypes.c_int32 * len(arr))(*arr)
        m = self._lib.rwkv_tok_decode(self._h, cbuf, len(arr), None, 0)
        out = ctypes.create_string_buffer(max(m, 1))
        self._lib.rwkv_tok_decode(self._h, cbuf, len(arr), out, m)
        return out.raw[:m]

    def decode(self, ids: Iterable[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.rwkv_tok_free(h)
            self._h = None


def load_best(vocab_dir: str | None = None):
    """The native tokenizer when it builds and loads, else the Python one."""
    try:
        return NativeBPETokenizer.load(vocab_dir)
    except (RuntimeError, OSError):
        from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer

        return BPETokenizer.load(vocab_dir)


if __name__ == "__main__":
    if sys.argv[1:] == ["build"]:
        print(build())
    else:
        sys.exit("usage: python -m rwkv_tpu_torch.tokenizer.native build")
