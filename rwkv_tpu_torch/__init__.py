"""rwkv_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of rwkv_tpu.

The module paths mirror rwkv_tpu's, so each counterpart is easy to find.
The package imports torch and numpy only: nothing of JAX and nothing of
rwkv_tpu. Entry points run on "cuda" unless the caller passes
device="cpu"; on the CPU every hand-written kernel's wrapper takes the
kernel's plain PyTorch version.

Serving across processes: parallel/multihost.py (initialize, pod_mesh) on
torch.distributed, tensor parallelism inside a process and data parallelism
across processes; parallel/mesh.py, sharding.py and tp_step.py below it.
"""

from rwkv_tpu_torch.version import __version__

from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.rwkv4 import (
    RWKVParams,
    WKVState,
    forward_seq,
    forward_step,
    init_state,
)

__all__ = [
    "__version__",
    "RWKVConfig",
    "RWKVParams",
    "WKVState",
    "forward_seq",
    "forward_step",
    "init_state",
]
