"""Bundled RWKV "20B" (GPT-NeoX-20B) tokenizer vocabulary.

rwkv20b.json.gz holds the 50,277 vocab entries and 50,008 merges as one
gzipped JSON bundle, byte-identical to the JAX package's copy, so that
`BPETokenizer.load()` with no arguments works out of the box.

Two consumers:
  * load_bundle() — in-memory (vocab dict, merges list) for the Python BPE.
  * ensure_files() — writes vocab.json + merges.txt into a cache dir for
    consumers that need the classic file pair (the native C++ tokenizer's
    loader, tokenizer/native.py).
"""

from __future__ import annotations

import gzip
import json
import os
import tempfile

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "rwkv20b.json.gz")


def available() -> bool:
    return os.path.isfile(ASSET)


def load_bundle() -> tuple[dict[str, int], list[tuple[str, str]]]:
    """(vocab, merges) from the bundled asset."""
    if not available():
        raise FileNotFoundError(f"bundled vocab missing ({ASSET}); pass an "
                                "explicit vocab dir")
    with gzip.open(ASSET, "rb") as f:
        data = json.loads(f.read().decode("utf-8"))
    return data["vocab"], [tuple(m) for m in data["merges"]]


def ensure_files(cache_dir: str | None = None) -> str:
    """Write vocab.json + merges.txt from the bundle; returns the dir.

    Default cache: $XDG_CACHE_HOME/rwkv_tpu_torch/vocab (or
    ~/.cache/rwkv_tpu_torch/vocab). Skips the write when both files exist.
    Each process writes its own temp files and renames them into place, so
    two concurrent first runs never install a half-written file."""
    if cache_dir is None:
        base = os.environ.get("XDG_CACHE_HOME",
                              os.path.join(os.path.expanduser("~"), ".cache"))
        cache_dir = os.path.join(base, "rwkv_tpu_torch", "vocab")
    vpath = os.path.join(cache_dir, "vocab.json")
    mpath = os.path.join(cache_dir, "merges.txt")
    if os.path.isfile(vpath) and os.path.isfile(mpath):
        return cache_dir
    vocab, merges = load_bundle()
    os.makedirs(cache_dir, exist_ok=True)
    fd_v, tmp_v = tempfile.mkstemp(dir=cache_dir, suffix=".vocab.tmp")
    fd_m, tmp_m = tempfile.mkstemp(dir=cache_dir, suffix=".merges.tmp")
    try:
        # mkstemp creates 0600; a shared cache wants the usual 0644
        os.fchmod(fd_v, 0o644)
        os.fchmod(fd_m, 0o644)
        with os.fdopen(fd_v, "w", encoding="utf-8") as f:
            json.dump(vocab, f, ensure_ascii=False, indent=4)
        with os.fdopen(fd_m, "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for a, b in merges:
                f.write(f"{a} {b}\n")
        os.replace(tmp_v, vpath)
        os.replace(tmp_m, mpath)
    finally:
        for t in (tmp_v, tmp_m):
            if os.path.exists(t):
                os.unlink(t)
    return cache_dir
