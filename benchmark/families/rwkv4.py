"""RWKV-4 served with q8 weights: the benchmark's parts of this family, found by
the configuration's `"family": "rwkv4"` (spec.family).

The weights are benchmark/weights.py's (int8 codes with a scale and an
offset per input channel, drawn on the device from the seed), the reference
forward pass benchmark/reference/model.py's, the tokenizer the "20B" BPE of
benchmark/reference/tokenizer.py, and the frozen bytes and operations
benchmark/arith.py's, which the readers of the decode stack and the prefill
use. The program is the port's engine, `RWKV(device, max_streams,
quant="q8")`, given the weights through `load_params` and the tokenizer that
the configuration names, and its pool, built as `apps/server.py::make_server`
builds it (the engine's step and prefill, its prefill type, the server's
--pool-chunk).

A slot's state is five leaves [L, E]: the two token-shift vectors (xy before
the time mix, dd before the channel mix) and the WKV state (aa, bb, pp), with
A = aa e^pp and B = bb e^pp. `state_err` compares the token shifts and the
WKV state's weight on a neutral next token, z = A / (B + e^u), which is what
the state contributes to the next output; aa, bb and pp alone are not
unique.
"""

from __future__ import annotations

import torch

from benchmark import weights as wmod
from benchmark.check import worse
from benchmark.reference.model import LEAVES, Reference
from benchmark.reference.tokenizer import Tokenizer

KERNELS = ("mm8", "decode_stack")
CONTROL = "tf32"  # the reference's precision that stands in as the control
make = wmod.make
reference = Reference


def tokenizer(cfg: dict) -> Tokenizer:
    """The benchmark's own 20B BPE, the same for every RWKV-4 configuration."""
    return Tokenizer()


def program(cfg: dict, weights: dict, device):
    """(engine, pool) of the port around the benchmark's weights."""
    from rwkv_tpu_torch.runtime.engine import RWKV
    from rwkv_tpu_torch.runtime.pool import InferencePool

    e = cfg["engine"]
    eng = RWKV(device=torch.device(device), max_streams=e["max_streams"], quant="q8",
               prefill_dtype=getattr(torch, e["prefill_dtype"]))
    eng.load_params(wmod.program_params(weights))
    eng.load_tokenizer(native=e["tokenizer"] == "native")
    pool = InferencePool(
        eng.params, eng.tokenizer, max_streams=e["max_streams"],
        step_fn=eng._step_fn, prefill_fn=eng._prefill_impl,
        prefill_dtype=eng.prefill_dtype, step_chunk=e["step_chunk"])
    return eng, pool


def slot_state(pool, slot: int) -> dict:
    """One slot's state, leaves [L, E] float64 on the host."""
    st = pool._state
    return {leaf: getattr(st, leaf)[:, slot].double().cpu() for leaf in LEAVES}


def vocab_rows(weights: dict) -> int:
    return weights["emb"].shape[0]


def z_of(state: dict, bonus: torch.Tensor) -> torch.Tensor:
    """A / (B + e^u) per channel, [L, E] float64."""
    pp, u = state["pp"], bonus.double()
    m = torch.maximum(pp, u)
    e = torch.exp(pp - m)
    return state["aa"] * e / (state["bb"] * e + torch.exp(u - m))


def state_err(prog: dict, ref: dict, weights: dict) -> float:
    """The largest, over layers and the three quantities (xy, dd, z), of
    |program - reference| / |reference| over the channels; NaN counts as
    infinitely wrong."""
    prog, ref = ({k: v.double().cpu() for k, v in d.items()} for d in (prog, ref))
    bonus = weights["att_bonus"].double().cpu()
    worst = 0.0
    pairs = [(prog[k], ref[k]) for k in ("xy", "dd")] + [(z_of(prog, bonus), z_of(ref, bonus))]
    for p, r in pairs:
        err = (p - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
        worst = worse(worst, float(err.max()))
    return worst
