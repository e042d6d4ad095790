"""Perplexity evaluation (counterpart of rwkv_tpu/eval/)."""
