"""One decode step over all L layers, q8 (kernel K1) or q4 (kernel K4)
(counterpart of rwkv_tpu/ops/pallas/decode_stack.py).

`decode_stack(params, token, state)` runs the embedding gather + ln0, every
layer (ln1, token-shift mix, k/v/r matvecs, WKV step, out-projection; ln2,
mix, relu(key)^2, value * sigmoid(gate)) and ln_out with the head's scaled
input on csrc/decode_stack.cu, which replaces the q8 and q4 branches of the
Pallas `_decode_stack_kernel`. The weight format follows the params: int8
QuantLinear families run K1, packed Quant4Linear families K4.
`forward_step_fused` adds the head through kernel K2 (ops/cuda/mm8.py) or K3
(ops/cuda/mm4.py) and the logit bias: the same signature and scalar/[B]
behaviour as the JAX `forward_step_fused`.

Bound on the card: the layers' weight bytes, L * 13 * E^2 in q8 (327 MB at
430M) and half that in q4 (164 MB), over device memory bandwidth; the head
adds E * Vp (52 MB; 26 MB in q4). The kernel reads each weight byte once per
step; csrc/decode_stack.cu describes the launch sequence (6 per layer, plus
one for ln_out).

In q4, att.output and ffn.value may pair rows within any even block that
divides their K (ops.quant.Quant4Linear); the other families must pair
globally (block None), as in the JAX kernel. Anything else raises.

State tensors are [L, B, E] f32 and must be contiguous (a stream sliced out
of a pool is not: pass `.contiguous()`). The kernel never writes its input
state; the new state is returned in new tensors.

On CPU tensors the wrapper runs `decode_stack_plain`; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rwkv_tpu_torch.models.rwkv4 import (
    RWKVParams,
    WKVState,
    _att_step,
    _ffn_step,
    _layer,
)
from rwkv_tpu_torch.ops.cuda import _build
from rwkv_tpu_torch.ops.cuda.mm4 import block_half, mm4
from rwkv_tpu_torch.ops.cuda.mm8 import mm8
from rwkv_tpu_torch.ops.layernorm import layer_norm
from rwkv_tpu_torch.ops.quant import Quant4Linear
from rwkv_tpu_torch.ops.wkv import WKVChannelState

# kernel launches, for showing that a path ran on the kernel: q8 (K1), q4 (K4)
launches = 0
launches_q4 = 0

_lib = None

# The pointer table of rwkv_decode_stack(), in the order of `enum Ptr` in
# csrc/decode_stack.cu.
_POINTERS = (
    "tokens", "emb", "ln0.weight", "ln0.bias", "ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias",
    "att.mix_k", "att.mix_v", "att.mix_r", "att.decay", "att.bonus",
    "att.key.w", "att.key.scale", "att.key.offset",
    "att.value.w", "att.value.scale", "att.value.offset",
    "att.receptance.w", "att.receptance.scale", "att.receptance.offset",
    "att.output.w", "att.output.scale", "att.output.offset",
    "ffn.mix_k", "ffn.mix_r",
    "ffn.key.w", "ffn.key.scale", "ffn.key.offset",
    "ffn.value.w", "ffn.value.scale", "ffn.value.offset",
    "ffn.receptance.w", "ffn.receptance.scale", "ffn.receptance.offset",
    "ln_out.weight", "ln_out.bias", "head.scale", "head.offset",
    "xy", "aa", "bb", "pp", "dd",
    "xy_out", "aa_out", "bb_out", "pp_out", "dd_out",
    "x", "xk", "xv", "xr", "rwkv", "fk", "fr", "kk", "xs_h", "off_h",
    "offs", "off_parts", "partial", "counters",
)
_PARAM_NAMES = _POINTERS[1:40]
# The matrix families in the order of rwkv_decode_stack()'s halves[], and
# which of them pair rows within a block in q4.
_FAMILIES = ("att.key", "att.value", "att.receptance", "att.output",
             "ffn.key", "ffn.value", "ffn.receptance")
_ROW_TILED = ("att.output", "ffn.value")


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("decode_stack")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rwkv_decode_stack.argtypes = [ctypes.POINTER(P), I, I, I, I, I, I, I,
                                          ctypes.POINTER(I), ctypes.c_longlong, I, I, P,
                                          ctypes.POINTER(I)]
        lib.rwkv_decode_stack.restype = I
        lib.rwkv_decode_stack_pointer_count.argtypes = []
        lib.rwkv_decode_stack_pointer_count.restype = I
        if lib.rwkv_decode_stack_pointer_count() != len(_POINTERS):
            raise RuntimeError("decode_stack.cu's pointer table does not match _POINTERS")
        _lib = lib
    return _lib


def _get(params: RWKVParams, dotted: str) -> torch.Tensor:
    obj = params
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _param_shapes(L: int, E: int, F: int, Vp: int, q4: bool) -> dict:
    sh = {"emb": (Vp, E), "ln0.weight": (E,), "ln0.bias": (E,),
          "ln_out.weight": (E,), "ln_out.bias": (E,), "head.scale": (E,), "head.offset": (E,)}
    for n in ("ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias", "att.mix_k", "att.mix_v",
              "att.mix_r", "att.decay", "att.bonus", "ffn.mix_k", "ffn.mix_r"):
        sh[n] = (L, E)
    for fam, (K, O) in {"att.key": (E, E), "att.value": (E, E), "att.receptance": (E, E),
                        "att.output": (E, E), "ffn.key": (E, F), "ffn.value": (F, E),
                        "ffn.receptance": (E, E)}.items():
        sh[fam + ".w"] = (L, K // 2, O) if q4 else (L, K, O)
        sh[fam + ".scale"] = (L, K)
        sh[fam + ".offset"] = (L, K)
    return sh


def _check(t: torch.Tensor, name: str, dtype, device, shape) -> None:
    if t.device != device:
        raise ValueError(f"decode_stack: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        if dtype == torch.int8 and t.dtype == torch.uint8:
            raise TypeError(f"decode_stack: {name} is uint8; the kernel takes int8 "
                            "(models.rwkv4.signedize_params at load time)")
        raise TypeError(f"decode_stack: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"decode_stack: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"decode_stack: {name} must be contiguous")


def _q4_halves(params: RWKVParams) -> list:
    """Half the pairing block of each matrix family (rwkv_decode_stack's
    halves[]) for all-Quant4Linear params; raises on a family of another
    format, a blocked column-sliced family, or a block that does not fit."""
    halves = []
    for fam in _FAMILIES:
        lin = _get(params, fam)
        if not isinstance(lin, Quant4Linear):
            raise TypeError(f"4-bit decode needs every matrix family Quant4Linear; {fam} is "
                            f"{type(lin).__name__} (models.rwkv4.quantize_params_q4)")
        if fam not in _ROW_TILED and lin.block is not None:
            raise ValueError(f"decode_stack: 4-bit column-sliced family {fam} must pair "
                             f"globally (block None), got block {lin.block}")
        halves.append(block_half(lin.block, lin.in_features, f"decode_stack: {fam}"))
    return halves


class _Prepared:
    """Checked parameter pointers and per-batch scratch for one params object."""

    def __init__(self, params: RWKVParams):
        self.params = params
        dev = params.emb.device
        L, E = params.n_layer, params.n_embd
        self.q4 = isinstance(params.att.key, Quant4Linear)
        self.halves = _q4_halves(params) if self.q4 else [0] * len(_FAMILIES)
        F = params.ffn.key.out_features
        Vp = params.emb.shape[0]
        shapes = _param_shapes(L, E, F, Vp, self.q4)
        ptrs = []
        for name in _PARAM_NAMES:
            t = _get(params, name[:-2] + ".wp" if self.q4 and name.endswith(".w") else name)
            dtype = torch.int8 if name.endswith(".w") else torch.float32
            _check(t, name, dtype, dev, shapes[name])
            if dtype == torch.int8 and t.data_ptr() % 16:
                raise ValueError(f"decode_stack: {name} must be 16-byte aligned")
            ptrs.append(t.data_ptr())
        if E % 16 or F % 16:
            raise ValueError(f"decode_stack: E ({E}) and F ({F}) must be multiples of 16")
        self.device, self.L, self.E, self.F, self.Vp = dev, L, E, F, Vp
        self.param_ptrs = ptrs
        self.scratch: dict = {}

    def buffers(self, B: int):
        s = self.scratch.get(B)
        if s is None:
            z = lambda *shape: torch.empty(shape, dtype=torch.float32, device=self.device)  # noqa: E731
            E, F = self.E, self.F
            tiles = -(-E // 128) + -(-F // 128)  # column tiles of 128 (csrc/qmv.cuh)
            s = {"xk": z(B, E), "xv": z(B, E), "xr": z(B, E), "rwkv": z(B, E),
                 "fk": z(B, E), "fr": z(B, E), "kk": z(B, F),
                 "offs": z(5, B), "off_parts": z(tiles, B)}
            self.scratch[B] = s
        return s


_prepared: _Prepared | None = None


def _prepare(params: RWKVParams) -> _Prepared:
    global _prepared
    if _prepared is None or _prepared.params is not params:
        _prepared = _Prepared(params)
    return _prepared


def decode_stack_plain(params: RWKVParams, token: torch.Tensor, state: WKVState):
    """The plain PyTorch version: returns (y [B, E], new state,
    xs_h [B, E] = ln_out(y) * head.scale, off_h [B] = ln_out(y) . head.offset)."""
    x = layer_norm(params.emb[token.long()].float(), params.ln0.weight, params.ln0.bias)
    new = {f: [] for f in WKVState._fields}
    for i in range(params.n_layer):
        ln1, ln2, att, ffn = _layer(params, i)
        x, xy, chan = _att_step(x, att, ln1, state.xy[i],
                                WKVChannelState(state.aa[i], state.bb[i], state.pp[i]))
        x, dd = _ffn_step(x, ffn, ln2, state.dd[i])
        for f, val in zip(WKVState._fields, (xy, chan.aa, chan.bb, chan.pp, dd)):
            new[f].append(val)
    h = layer_norm(x, params.ln_out.weight, params.ln_out.bias)
    return (x, WKVState(*(torch.stack(new[f]) for f in WKVState._fields)),
            h * params.head.scale, h @ params.head.offset)


def decode_stack(params: RWKVParams, token: torch.Tensor, state: WKVState):
    """One decode step for B streams. token: [B] ints; state leaves [L, B, E].
    Returns (y [B, E], new state, xs_h [B, E], off_h [B]) as decode_stack_plain."""
    if params.emb.device.type == "cpu" and token.device.type == "cpu":
        if isinstance(params.att.key, Quant4Linear):
            _q4_halves(params)  # the same format checks as the kernel's
        return decode_stack_plain(params, token, state)
    global launches, launches_q4
    prep = _prepare(params)
    dev = prep.device
    if dev.type != "cuda":
        raise ValueError(f"decode_stack runs on CUDA or CPU tensors, got {dev}")
    if token.dim() != 1:
        raise ValueError(f"decode_stack: token must be [B], got {tuple(token.shape)}")
    B = token.shape[0]
    L, E, F = prep.L, prep.E, prep.F
    if token.device != dev:
        raise ValueError(f"decode_stack: token is on {token.device}, expected {dev}")
    tok = token.to(torch.int32).contiguous()
    for name, t in zip(WKVState._fields, state):
        _check(t, f"state.{name}", torch.float32, dev, (L, B, E))
    new_state = WKVState(*(torch.empty_like(t) for t in state))
    y = torch.empty((B, E), dtype=torch.float32, device=dev)
    xs_h = torch.empty((B, E), dtype=torch.float32, device=dev)
    off_h = torch.empty((B,), dtype=torch.float32, device=dev)
    buf = prep.buffers(B)
    partial, counters, target = _build.split_scratch(dev, "decode_stack")
    table = ([tok.data_ptr()] + prep.param_ptrs
             + [t.data_ptr() for t in state] + [t.data_ptr() for t in new_state]
             + [y.data_ptr()] + [buf[n].data_ptr() for n in ("xk", "xv", "xr", "rwkv", "fk",
                                                               "fr", "kk")]
             + [xs_h.data_ptr(), off_h.data_ptr(), buf["offs"].data_ptr(),
                buf["off_parts"].data_ptr(), partial.data_ptr(), counters.data_ptr()])
    lib = _kernel()
    arr = (ctypes.c_void_p * len(table))(*table)
    halves = (ctypes.c_int * len(prep.halves))(*prep.halves)
    n = ctypes.c_int(0)
    err = lib.rwkv_decode_stack(arr, len(table), L, B, E, F, prep.Vp, int(prep.q4), halves,
                                partial.numel(), counters.numel(), target,
                                torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(n))
    if prep.q4:
        launches_q4 += n.value
    else:
        launches += n.value
    _build.check(lib, err, "decode_stack")
    return y, new_state, xs_h, off_h


def forward_step_fused(params: RWKVParams, token: torch.Tensor, state: WKVState
                       ) -> Tuple[torch.Tensor, WKVState]:
    """Full decode step on kernels K1 (layers) and K2 (head), or in q4 on K4
    and K3, + logit_bias.

    token: scalar (state leaves [L, E]) or [B] (state leaves [L, B, E]).
    Returns (logits [..., Vp], new state), as models.rwkv4.forward_step."""
    unbatched = token.dim() == 0
    tok = token.reshape(1) if unbatched else token
    st = WKVState(*(s[:, None] for s in state)) if unbatched else state
    _, new_state, xs_h, off_h = decode_stack(params, tok, st)
    head = params.head
    if isinstance(head, Quant4Linear):
        logits = mm4(xs_h, head.wp, block=head.block, row_add=off_h, col_add=params.logit_bias)
    else:
        logits = mm8(xs_h, head.w, row_add=off_h, col_add=params.logit_bias)
    if unbatched:
        return logits[0], WKVState(*(s[:, 0] for s in new_state))
    return logits, new_state
