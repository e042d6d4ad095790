"""Tensor- and data-parallel decode and prefill (counterpart of rwkv_tpu/parallel)."""
