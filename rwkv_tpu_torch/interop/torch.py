"""TorchRWKV: the reference's pytorch binding shape over the port's engine
(counterpart of rwkv_tpu/interop/torch.py).

    w = TorchRWKV("model.bin")              # or params=..., device="cpu"
    logits, state = w.forward(token, w.empty_state())
    logits, state = w.forward_batch(tokens, state)   # tokens [B], state [L, B, E]

State is passed explicitly and functionally, as the reference's
RwkvCppWrapper + attachState passes it: the tensors given in are never
written, and each call returns new ones. A call is one step of the engine's
decode step (`RWKV._step_fn`): kernels K1 + K2 for a .bin, K4 + K3 for a q4
artifact, the tensor-parallel body with sharding=; the plain versions on the
CPU. forward_batch runs the same step at B (the JAX wrapper's forward_batch
runs the plain forward_step there). Logits and state are tensors on the
engine's device; the logits have the width the JAX wrapper returns for the
same source (a .bin: 50,688, padded columns at -1e9).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from rwkv_tpu_torch.models.rwkv4 import WKVState, init_state
from rwkv_tpu_torch.runtime.engine import RWKV


class TorchRWKV:
    """forward(token, state) -> (logits, state), everything torch tensors."""

    def __init__(self, model_path: Optional[str] = None, params=None, device=None, *,
                 sharding=None):
        if params is None and not model_path:
            raise ValueError("need model_path or params")
        self._eng = RWKV(device=device, sharding=sharding)
        if params is not None:
            self._eng.load_params(params)
        else:
            self._eng.load_file(model_path)

    @property
    def device(self) -> torch.device:
        return self._eng.device

    @property
    def n_layer(self) -> int:
        return self._eng.config.n_layer

    @property
    def n_embd(self) -> int:
        return self._eng.config.n_embd

    def empty_state(self) -> list[torch.Tensor]:
        """[xy, aa, bb, pp, dd], each [L, E] float32 (reference order)."""
        return list(init_state(self._eng.config, device=self.device))

    def _step(self, tokens: torch.Tensor, state: Sequence[torch.Tensor]):
        st = WKVState(*(torch.as_tensor(s).to(self.device, torch.float32).contiguous()
                        for s in state))
        logits, new = self._eng._step_fn(self._eng.params, tokens, st)
        # the JAX engine's width for this source: cut the port's padding, or
        # pad with the padded columns' -1e9
        width = self._eng._session_vocab
        logits = logits[..., :width]
        if logits.shape[-1] < width:
            logits = torch.nn.functional.pad(logits, (0, width - logits.shape[-1]), value=-1e9)
        return logits, list(new)

    def forward(self, token: int | torch.Tensor, state: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, list[torch.Tensor]]:
        """One token, state leaves [L, E]: (logits [V], new state)."""
        tok = torch.tensor(int(token), dtype=torch.int64, device=self.device)
        return self._step(tok, state)

    def forward_batch(self, tokens: torch.Tensor, state: Sequence[torch.Tensor]
                      ) -> Tuple[torch.Tensor, list[torch.Tensor]]:
        """tokens [B] int, state leaves [L, B, E]: (logits [B, V], new state)."""
        toks = torch.as_tensor(tokens).to(self.device, torch.int64).reshape(-1)
        return self._step(toks, state)
