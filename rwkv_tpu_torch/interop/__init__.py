"""Interop layers (counterpart of rwkv_tpu/interop): torch.py holds
TorchRWKV, the reference's RwkvCppWrapper shape over the port's engine."""
