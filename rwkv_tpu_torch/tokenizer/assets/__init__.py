"""Bundled RWKV "20B" (GPT-NeoX-20B) tokenizer vocabulary.

rwkv20b.json.gz holds the 50,277 vocab entries and 50,008 merges as one
gzipped JSON bundle, byte-identical to the JAX package's copy, so that
`BPETokenizer.load()` with no arguments works out of the box.
"""

from __future__ import annotations

import gzip
import json
import os

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
