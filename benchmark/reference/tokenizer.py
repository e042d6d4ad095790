"""The benchmark's own byte-level BPE tokenizer for the RWKV "20B" (GPT-NeoX)
vocab: encode and decode, independent of the program under test.

The vocab and merges are a frozen copy (rwkv20b.json.gz beside this file).
Pre-tokenization follows the GPT-2 pattern

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

scanned by hand with the standard library's unicodedata (letters: category
L*, numbers: N*, whitespace: the Unicode White_Space property), so that it
needs no `regex` module. Merges are applied greedily by rank. Decode maps
the byte-level alphabet back to bytes; a vocab entry that holds characters
outside that alphabet (the added runs of spaces) stands for its own UTF-8.
"""

from __future__ import annotations

import gzip
import json
import os
import unicodedata

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rwkv20b.json.gz")

# the Unicode White_Space property (PropList.txt)
WHITE_SPACE = frozenset(chr(c) for c in (
    *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000))
CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def char_kind(c: str) -> str:
    """'s' whitespace, 'L' letter, 'N' number, 'o' anything else."""
    if c in WHITE_SPACE:
        return "s"
    cat = unicodedata.category(c)[0]
    return cat if cat in ("L", "N") else "o"


def pretokenize(text: str) -> list[str]:
    """Split text as the GPT-2 pattern does (module docstring)."""
    out = []
    i, n = 0, len(text)
    kinds = [char_kind(c) for c in text]
    while i < n:
        if text[i] == "'":
            hit = next((s for s in CONTRACTIONS if text.startswith(s, i + 1)), None)
            if hit is not None:
                out.append(text[i:i + 1 + len(hit)])
                i += 1 + len(hit)
                continue
        start = i
        if text[i] == " " and i + 1 < n and kinds[i + 1] != "s":
            i += 1  # " ?" before a run of one kind
        k = kinds[i]
        if k != "s":
            j = i
            while j < n and kinds[j] == k:
                j += 1
            out.append(text[start:j])
            i = j
            continue
        # whitespace: \s+(?!\S), else \s+
        j = i
        while j < n and kinds[j] == "s":
            j += 1
        if j < n and j - i > 1:
            j -= 1  # leave the last space to the next token
        out.append(text[i:j])
        i = j
    return out


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class Tokenizer:
    def __init__(self):
        with gzip.open(ASSET, "rb") as f:
            data = json.loads(f.read().decode("utf-8"))
        self.encoder: dict[str, int] = data["vocab"]
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(data["merges"])}
        self.byte_enc = _bytes_to_unicode()
        self.byte_dec = {c: b for b, c in self.byte_enc.items()}
        self._cache: dict[str, list[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, word: str) -> list[str]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        parts = list(word)
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 62))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[word] = parts
        return parts

    def encode(self, text: str) -> list[int]:
        ids = []
        for piece in pretokenize(text):
            mapped = "".join(self.byte_enc[b] for b in piece.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def token_bytes(self, i: int) -> bytes:
        """The bytes of one id."""
        out = bytearray()
        for c in self.decoder[int(i)]:
            b = self.byte_dec.get(c)
            out += c.encode("utf-8") if b is None else bytes((b,))
        return bytes(out)

    def decode(self, ids) -> str:
        return b"".join(self.token_bytes(i) for i in ids).decode("utf-8", errors="replace")
