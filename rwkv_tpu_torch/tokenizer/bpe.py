"""GPT-2 style byte-level BPE tokenizer (RWKV "20B" NeoX vocab, 50277 tokens).

Functional equivalent of the reference's C++ GPT2Tokenizer
(include/rwkv/tokenizer/tokenizer.h:42-248): same vocab.json/merges.txt
inputs, same byte<->unicode table, same greedy merge-by-rank algorithm.
Differences by design:
  * the pre-tokenization regex uses the proper unicode classes \\p{L}/\\p{N}
    (what the vocab was trained with) rather than the reference's C-locale
    [[:alpha:]] approximation;
  * decode goes through UTF-8 byte reassembly, so multi-byte codepoints split
    across tokens round-trip correctly.

The 50,277-entry vocab is BUNDLED (rwkv_tpu_torch/tokenizer/assets, a model
artifact the reference also ships in-tree): `BPETokenizer.load()` with no
arguments uses it. An explicit directory with vocab.json + merges.txt (or
$RWKV_TPU_VOCAB) overrides the bundle.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Iterable, Sequence

try:
    import regex as _re

    _PATTERN = _re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
    )
except ImportError:  # pragma: no cover - regex is in the baked image
    import re as _re

    _PATTERN = _re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+"""
    )


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """The standard GPT-2 reversible byte->printable-codepoint table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class BPETokenizer:
    def __init__(self, encoder: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = encoder
        self.decoder = {v: k for k, v in encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self._cache: dict[str, list[str]] = {}

    # -- construction -------------------------------------------------------

    @classmethod
    def load(cls, vocab_dir: str | None = None) -> "BPETokenizer":
        """Load vocab.json + merges.txt from a directory (or $RWKV_TPU_VOCAB),
        falling back to the bundled 50,277-entry RWKV "20B" vocab."""
        vocab_dir = vocab_dir or os.environ.get("RWKV_TPU_VOCAB")
        if not vocab_dir:
            from rwkv_tpu_torch.tokenizer import assets

            if assets.available():
                return cls(*assets.load_bundle())
            raise ValueError(
                "no vocab: pass vocab_dir or set $RWKV_TPU_VOCAB to a "
                "directory containing vocab.json and merges.txt (bundled "
                "asset missing from rwkv_tpu_torch/tokenizer/assets)"
            )
        return cls.load_files(
            os.path.join(vocab_dir, "vocab.json"),
            os.path.join(vocab_dir, "merges.txt"),
        )

    @classmethod
    def load_files(cls, vocab_file: str, merges_file: str) -> "BPETokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            encoder = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            next(f)  # version header line
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                a, sep, b = line.partition(" ")
                if sep:
                    merges.append((a, b))
        return cls(encoder, merges)

    # -- core BPE ------------------------------------------------------------

    def _bpe(self, token: str) -> list[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        if len(word) == 1:
            return [token]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 60))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        if len(token) < 24:
            self._cache[token] = word
        return word

    # -- public API ----------------------------------------------------------

    def encode(self, text: str) -> list[int]:
        enc = self.encoder
        be = self.byte_encoder
        ids: list[int] = []
        for m in _PATTERN.findall(text):
            mapped = "".join(be[b] for b in m.encode("utf-8"))
            ids.extend(enc[piece] for piece in self._bpe(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytes(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace")

    def tokenize(self, text: str) -> list[str]:
        """BPE piece strings for `text`, in byte-unicode form (parity with
        the reference GPT2Tokenizer::tokenize, tokenizer.h:116-125)."""
        pieces: list[str] = []
        for m in _PATTERN.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in m.encode("utf-8"))
            pieces.extend(self._bpe(mapped))
        return pieces

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        """Raw bytes — lets streaming callers hold partial UTF-8 sequences."""
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        return bytes(self.byte_decoder[c] for c in text)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)


class StreamDecoder:
    """Incremental detokenizer: feeds out only complete UTF-8 text.

    Decode-as-you-generate support the reference lacks (its chat app prints
    possibly-invalid partial sequences, examples/terminalchat/chat.cpp:78).
    """

    def __init__(self, tokenizer: BPETokenizer):
        self.tok = tokenizer
        self.pending = b""

    def feed(self, ids: Sequence[int]) -> str:
        self.pending += self.tok.decode_bytes(ids)
        # emit the longest prefix that is valid UTF-8
        for cut in range(len(self.pending), max(len(self.pending) - 4, -1), -1):
            try:
                out = self.pending[:cut].decode("utf-8")
            except UnicodeDecodeError:
                continue
            self.pending = self.pending[cut:]
            return out
        return ""

    def flush(self) -> str:
        out = self.pending.decode("utf-8", errors="replace")
        self.pending = b""
        return out
