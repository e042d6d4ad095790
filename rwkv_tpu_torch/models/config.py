"""Model configuration for RWKV-v4.

The reference engine hardcodes vocab_size=50277 (the RWKV "20B" NeoX
tokenizer) and derives (n_layer, n_embd) from the checkpoint header
(reference: include/rwkv/cuda/rwkv.cu:650-651). We make all three explicit.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """Static architecture description of an RWKV-v4 model.

    Attributes:
      n_layer:    number of residual blocks (reference: `n_layers`).
      n_embd:     embedding width E (reference: `n_emb`).
      vocab_size: logit count; 50277 for all released RWKV-4 checkpoints.
      ffn_mult:   hidden multiple of the channel-mix FFN (always 4 in v4:
                  reference getSize() uses a*b*b*4 for ffn_k,
                  include/rwkv/rwkv/rwkv.h:126).
    """

    n_layer: int
    n_embd: int
    vocab_size: int = 50277
    ffn_mult: int = 4

    @property
    def n_ffn(self) -> int:
        return self.n_embd * self.ffn_mult

    # Published RWKV-4 model sizes, for convenience in benches/tests.
    @staticmethod
    def rwkv4_169m() -> "RWKVConfig":
        return RWKVConfig(n_layer=12, n_embd=768)

    @staticmethod
    def rwkv4_430m() -> "RWKVConfig":
        return RWKVConfig(n_layer=24, n_embd=1024)

    @staticmethod
    def rwkv4_1b5() -> "RWKVConfig":
        return RWKVConfig(n_layer=24, n_embd=2048)

    @staticmethod
    def rwkv4_3b() -> "RWKVConfig":
        return RWKVConfig(n_layer=32, n_embd=2560)

    @staticmethod
    def rwkv4_7b() -> "RWKVConfig":
        return RWKVConfig(n_layer=32, n_embd=4096)

    @staticmethod
    def rwkv4_14b() -> "RWKVConfig":
        return RWKVConfig(n_layer=40, n_embd=5120)

    @staticmethod
    def tiny_test(n_layer: int = 2, n_embd: int = 16, vocab_size: int = 97) -> "RWKVConfig":
        """A deliberately small + oddly-shaped config for CPU unit tests."""
        return RWKVConfig(n_layer=n_layer, n_embd=n_embd, vocab_size=vocab_size)
