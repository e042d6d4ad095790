"""One decode step over all L layers, q8 (kernel K1), q4 (kernel K4) or W8A8
(the stack of kernel K5) (counterpart of rwkv_tpu/ops/pallas/decode_stack.py).

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
step, in one cooperative launch per step whatever the format: four phases a
layer and one for ln_out, separated by grid barriers (csrc/decode_stack.cu
says how). A launch the card refuses raises; there is no other route.

q8 at TC_MIN_B <= B <= 16 (tc_path) runs K1's matvec phases on the tensor
cores (decode_stack_kernel_tc, csrc/stack_tc.cuh): a TMA ring of weight
tiles into wgmma, every weight byte read once a step for all B rows, the
f32 activations as three exact bf16 pieces, so its results stay within f32
rounding of decode_stack_plain. Each phase is cut by tc_plan; the weight
families' tensor maps are encoded once per params (`prepare`). Below
TC_MIN_B, where a step is a chain of barrier latencies, the CUDA-core
kernel (csrc/qmv.cuh) runs it.
`stamps=` takes an int64 CUDA tensor of at least 4 * L + 2 entries, into
which the kernel writes %globaltimer at its start, after each barrier and
at its end (tools/decode_profile.py reads the time of each phase).

a8=True runs every matvec as W8A8, as the JAX kernel's a8 branch does: the
input of each matvec is quantized to int8 codes with a dynamic symmetric
scale, and the codes times the int8 weights are summed exactly. The inputs of
att k/v/r, ffn key/receptance and the head get one scale per batch row; those
of att.output and ffn.value one per block of `a8_block` channels, where the
JAX kernel quantizes each of its `tile`-wide slices. So the block is a
numerical parameter: the JAX engine's is models.rwkv4.a8_block_for(E) (512
at 430M), the default here; it must be a multiple of 128 that divides E.
a8 with 4-bit weights raises. head_a8=True runs only the head as W8A8 (in
the JAX package it applies to its standalone head, which the port always
uses).

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
    a8_block_for,
)
from rwkv_tpu_torch.ops.cuda import _build
from rwkv_tpu_torch.ops.cuda.mm4 import block_half, mm4
from rwkv_tpu_torch.ops.cuda.mm8 import mm8, mm8_a8, mm8_a8_plain
from rwkv_tpu_torch.ops.layernorm import layer_norm
from rwkv_tpu_torch.ops.quant import Quant4Linear, QuantLinear
from rwkv_tpu_torch.ops.wkv import WKVChannelState
from rwkv_tpu_torch.utils.metrics import metrics

# kernel launches, for showing that a path ran on the kernel: q8 (K1), q4
# (K4), a8 (K5's stack); one per step. launches_tc: the q8 launches that ran
# on the tensor cores (counted in `launches` too); each also adds one to the
# metrics registry's TC_COUNTER, graph captures included.
launches = 0
launches_q4 = 0
launches_a8 = 0
launches_tc = 0
TC_COUNTER = "decode_stack.launches_tc"

# The batch rows that run K1 on the tensor cores (tc_path): B* up to the 16
# rows of one wgmma operand. B* = 4: on an H100 at 430M widths the tensor-
# core kernel is slower at 1 and 2 rows (1.99 against 1.30, 1.67 against
# 1.52 ms a step), where a step is a chain of barriers, and faster from 4
# (1.69 against 2.15); at 14B's it is even at 1 row and faster from 2
# (PERF.md, tools/decode_profile.py --paths).
TC_MIN_B = 4
TC_MAX_B = 16
_TC_ROW_BYTES = 96     # operand bytes a weight row: 3 bf16 pieces x 16 batch rows
_TILE = 128            # output columns a tile

_lib = None

# The pointer table of rwkv_decode_stack(), in the order of `enum Ptr` in
# csrc/decode_stack.cu (tests/test_torch_kernel_tables.py holds the two
# against each other).
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
    "xy_in", "aa_in", "bb_in", "pp_in", "dd_in",
    "xy_out", "aa_out", "bb_out", "pp_out", "dd_out",
    "x", "rwkv", "fr", "kk", "xs_h", "off_h",
    "offs", "off_parts", "amax", "amax_parts", "partial", "counters", "stamps", "fold_parts",
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
                                          ctypes.POINTER(I), I, ctypes.c_longlong, I, P,
                                          ctypes.POINTER(I), ctypes.POINTER(I)]
        lib.rwkv_decode_stack.restype = I
        lib.rwkv_decode_stack_grid.argtypes = [I, I, I, I, ctypes.POINTER(I)]
        lib.rwkv_decode_stack_grid.restype = I
        lib.rwkv_barrier_probe.argtypes = [I, I, P, P]
        lib.rwkv_barrier_probe.restype = I
        lib.rwkv_decode_stack_tc.argtypes = [ctypes.POINTER(P), I, I, I, I, I, I,
                                             ctypes.POINTER(I), P, I, ctypes.c_longlong, I, P,
                                             ctypes.POINTER(I), ctypes.POINTER(I)]
        lib.rwkv_decode_stack_tc.restype = I
        lib.rwkv_decode_stack_tc_caps.argtypes = [I, ctypes.POINTER(I), ctypes.POINTER(I),
                                                  ctypes.POINTER(I)]
        lib.rwkv_decode_stack_tc_caps.restype = I
        lib.rwkv_decode_stack_tc_maps.argtypes = [ctypes.POINTER(P), I, I, I, P]
        lib.rwkv_decode_stack_tc_maps.restype = I
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


def tc_path(B: int, E: int, F: int, fmt: str) -> bool:
    """Whether a step of B batch rows at widths E and F in weight format fmt
    ("q8", "q4" or "a8") runs K1 on the tensor cores: q8 from TC_MIN_B to
    TC_MAX_B rows, with E and F whole column tiles of 128."""
    return (fmt == "q8" and TC_MIN_B <= B <= TC_MAX_B and E % _TILE == 0
            and F % _TILE == 0)


def _phase_mats(E: int, F: int):
    """Per phase kind (A, B, C, D): the contraction length of each matrix,
    the output width, and whether the phase is folded (its operand beside 4
    LayerNormed rows of E)."""
    return (((E, E, E), E, True), ((E,), E, False), ((E,), F, True), ((F, E), E, False))


def tc_plan(B: int, E: int, F: int, grid: int, op_stages: int, stage_rows: int,
            partial_cap: int = _build.SPLIT_FLOATS, counter_cap: int = _build.SPLIT_TILES
            ) -> tuple:
    """How the TC kernel cuts each phase: 8 ints, the stages (stage_rows
    weight rows each) a split of the contraction for phases A, B, C, D, then
    the column tiles of 128 a group. A unit (one matrix's split over a group
    of tiles) is one block's work, so the units may not outnumber the grid;
    a split's operand fits in op_stages stages (rwkv_decode_stack_tc_caps)
    in the folded phases and also over the 4 LayerNormed rows in the others;
    the partials [splits, B, O] fit the split-K scratch, the tiles its
    counters. Chosen: the least stages of the longest unit plus half a stage
    for each split's [B, 128] partial that a tile's last unit reads back (a
    weight of one, tried with 64-row stages, chose longer splits at 430M
    widths that ran 14 % slower on an H100)."""
    free = (op_stages * stage_rows * _TC_ROW_BYTES + 16 * E) // (stage_rows * _TC_ROW_BYTES)
    ks_out, tiles_out = [], []
    for ks_k, O, fold in _phase_mats(E, F):
        tiles = O // _TILE
        cap = op_stages if fold else free
        kst = [K // stage_rows for K in ks_k]
        best = None
        for ks in range(1, min(cap, max(kst)) + 1):
            splits = sum(-(-k // ks) for k in kst)
            if splits * B * O > partial_cap or tiles > counter_cap - 64:
                continue
            for T in range(1, tiles + 1):
                if splits * -(-tiles // T) > grid:
                    continue
                cost = ks * T + splits / 2
                if best is None or cost < best[0]:
                    best = (cost, ks, T)
                break  # a larger T only lengthens the units
        if best is None:
            raise ValueError(f"decode_stack: no tensor-core plan for E={E}, F={F}, B={B} on "
                             f"{grid} blocks with {op_stages} operand stages")
        ks_out.append(best[1])
        tiles_out.append(best[2])
    return tuple(ks_out + tiles_out)


class _Prepared:
    """Checked parameter pointers and per-batch scratch for one params object;
    for q8 params the TC kernel can take, its weight families' tensor maps."""

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
        self.tc_maps = None  # the tensor maps' 64-aligned address; its buffer below
        if dev.type == "cuda" and not self.q4 and E % _TILE == 0 and F % _TILE == 0:
            lib = _kernel()
            self._maps_buf = ctypes.create_string_buffer(7 * 128 + 64)
            addr = ctypes.addressof(self._maps_buf)
            addr += -addr % 64
            w = [_get(params, fam + ".w").data_ptr() for fam in _FAMILIES]
            with torch.cuda.device(dev):
                _build.check(lib, lib.rwkv_decode_stack_tc_maps(
                    (ctypes.c_void_p * 7)(*w), L, E, F, addr), "decode_stack tensor maps")
                rows, op, grid = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
                _build.check(lib, lib.rwkv_decode_stack_tc_caps(
                    E, ctypes.byref(rows), ctypes.byref(op), ctypes.byref(grid)),
                    "decode_stack tensor-core capacity")
            self.tc_maps, self.tc_op_stages, self.tc_grid = addr, op.value, grid.value
            self.tc_stage_rows = rows.value
            self.tc_plans: dict = {}

    def tc_plan(self, B: int):
        p = self.tc_plans.get(B)
        if p is None:
            p = self.tc_plans[B] = (ctypes.c_int * 8)(*tc_plan(
                B, self.E, self.F, self.tc_grid, self.tc_op_stages, self.tc_stage_rows))
        return p

    def buffers(self, B: int):
        s = self.scratch.get(B)
        if s is None:
            z = lambda *shape: torch.empty(shape, dtype=torch.float32, device=self.device)  # noqa: E731
            E, F = self.E, self.F
            tiles = -(-E // 128) + -(-F // 128)  # column tiles of 128 (csrc/qmv.cuh)
            s = {"rwkv": z(B, E), "fr": z(B, E), "kk": z(B, F),
                 # the rank-1 offset terms are summed in double
                 "offs": z(B).double(), "off_parts": z(tiles, B).double(),
                 "amax": z(2, B), "amax_parts": z(tiles, B),
                 # the TC kernel's folded-phase sums (csrc/stack_tc.cuh's TcNext)
                 "fold_parts": z(-(-E // 128), 16 * 8 + 6).double()}
            self.scratch[B] = s
        return s


_prepared: _Prepared | None = None


def _prepare(params: RWKVParams) -> _Prepared:
    global _prepared
    if _prepared is None or _prepared.params is not params:
        _prepared = _Prepared(params)
    return _prepared


def prepare(params: RWKVParams) -> None:
    """Check CUDA params and make what every step of them reuses (the
    pointer table, the tensor maps of the TC kernel), ahead of the first
    step: the engine calls it when its parameters are made."""
    if params.emb.device.type == "cuda":
        _prepare(params)


def _a8_block(params: RWKVParams, a8_block) -> int:
    """The checked a8 block of the row-tiled families' inputs."""
    if isinstance(params.att.key, Quant4Linear):
        raise ValueError("a8 and 4-bit weights are mutually exclusive")
    E, F = params.n_embd, params.ffn.key.out_features
    block = a8_block_for(E) if a8_block is None else int(a8_block)
    if block <= 0 or block % 128 or E % block or F % block:
        raise ValueError(f"a8_block {block} must be a multiple of 128 that divides E ({E}) "
                         f"and F ({F})")
    return block


def _offset_term(x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """x . offset per row, summed in double (exact products) and rounded
    once, as the kernels sum the rank-1 term."""
    return (x.double() @ offset.double()).float()


def _qmm_a8(x: torch.Tensor, lin: QuantLinear, block: int | None = None) -> torch.Tensor:
    """W8A8 x @ lin: x * scale quantized per row (or per `block` channels),
    the exact integer product, plus the rank-1 offset term."""
    return mm8_a8_plain(x * lin.scale, lin.w, block=block) + _offset_term(x, lin.offset)[:, None]


def decode_stack_plain(params: RWKVParams, token: torch.Tensor, state: WKVState, *,
                       a8: bool = False, a8_block: int | None = None):
    """The plain PyTorch version: returns (y [B, E], new state,
    xs_h [B, E] = ln_out(y) * head.scale, off_h [B] = ln_out(y) . head.offset)."""
    mms = ()  # the products: f32-widening, or a8
    if a8:  # the column-sliced families quantize per row, the row-tiled per block
        block = _a8_block(params, a8_block)
        mms = (_qmm_a8, lambda x, lin: _qmm_a8(x, lin, block))
    x = layer_norm(params.emb[token.long()].float(), params.ln0.weight, params.ln0.bias)
    new = {f: [] for f in WKVState._fields}
    for i in range(params.n_layer):
        ln1, ln2, att, ffn = _layer(params, i)
        chan = WKVChannelState(state.aa[i], state.bb[i], state.pp[i])
        x, xy, chan = _att_step(x, att, ln1, state.xy[i], chan, *mms)
        x, dd = _ffn_step(x, ffn, ln2, state.dd[i], *mms)
        for f, val in zip(WKVState._fields, (xy, chan.aa, chan.bb, chan.pp, dd)):
            new[f].append(val)
    h = layer_norm(x, params.ln_out.weight, params.ln_out.bias)
    return (x, WKVState(*(torch.stack(new[f]) for f in WKVState._fields)),
            h * params.head.scale, _offset_term(h, params.head.offset))


def decode_stack(params: RWKVParams, token: torch.Tensor, state: WKVState, *,
                 a8: bool = False, a8_block: int | None = None,
                 stamps: torch.Tensor | None = None, tc: bool | None = None):
    """One decode step for B streams. token: [B] ints; state leaves [L, B, E].
    Returns (y [B, E], new state, xs_h [B, E], off_h [B]) as decode_stack_plain.
    stamps: see the module docstring (CUDA only). tc: run q8 on the tensor
    cores (True) or the CUDA cores (False) whatever tc_path says (None:
    as it says); True raises where the TC kernel cannot run the step."""
    return _decode(params, token, state, a8, a8_block, stamps, tc)[:4]


def stack_grid(B: int, E: int, *, q4: bool = False, a8: bool = False) -> int:
    """Blocks of the step's cooperative launch on the current CUDA device at
    batch B and width E: the occupancy API's blocks per SM times the SMs."""
    lib = _kernel()
    g = ctypes.c_int(0)
    _build.check(lib, lib.rwkv_decode_stack_grid(B, E, int(q4), int(a8), ctypes.byref(g)),
                 "decode_stack grid")
    return g.value


def barrier_probe(grid: int, n: int, word: torch.Tensor) -> None:
    """One cooperative launch of `grid` blocks that runs n grid barriers and
    nothing else, on the 64 int32 words of `word` (zero before the first
    call): the probe of tools/qmv_probe.py."""
    if word.dtype != torch.int32 or word.numel() < 64 or word.device.type != "cuda":
        raise ValueError("barrier_probe: word must be 64 int32 on a CUDA device")
    lib = _kernel()
    _build.check(lib, lib.rwkv_barrier_probe(grid, n, word.data_ptr(),
                                             torch.cuda.current_stream(word.device).cuda_stream),
                 "barrier_probe")


def _decode(params, token, state, a8, a8_block, stamps=None, tc=None):
    """decode_stack, and the row maxima of xs_h [B] that the a8 head reads
    (None on the CPU and without a8)."""
    if params.emb.device.type == "cpu" and token.device.type == "cpu":
        if isinstance(params.att.key, Quant4Linear):
            _q4_halves(params)  # the same format checks as the kernel's
        return decode_stack_plain(params, token, state, a8=a8, a8_block=a8_block) + (None,)
    global launches, launches_q4, launches_a8, launches_tc
    block = _a8_block(params, a8_block) if a8 else 0
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
    if stamps is not None:
        _check(stamps, "stamps", torch.int64, dev, (stamps.numel(),))
        if stamps.numel() < 4 * L + 2:
            raise ValueError(f"decode_stack: stamps needs {4 * L + 2} entries")
    partial, counters, _ = _build.split_scratch(dev, "decode_stack")
    table = ([tok.data_ptr()] + prep.param_ptrs
             + [t.data_ptr() for t in state] + [t.data_ptr() for t in new_state]
             + [y.data_ptr()] + [buf[n].data_ptr() for n in ("rwkv", "fr", "kk")]
             + [xs_h.data_ptr(), off_h.data_ptr()]
             + [buf[n].data_ptr() for n in ("offs", "off_parts", "amax", "amax_parts")]
             + [partial.data_ptr(), counters.data_ptr(),
                0 if stamps is None else stamps.data_ptr(), buf["fold_parts"].data_ptr()])
    lib = _kernel()
    arr = (ctypes.c_void_p * len(table))(*table)
    n, grid = ctypes.c_int(0), ctypes.c_int(0)
    fmt = "a8" if block else ("q4" if prep.q4 else "q8")
    on_tc = tc_path(B, E, F, fmt) if tc is None else bool(tc)
    if on_tc and (fmt != "q8" or prep.tc_maps is None or not 1 <= B <= TC_MAX_B):
        raise ValueError(f"decode_stack: the tensor-core kernel runs q8 at 1..{TC_MAX_B} rows "
                         f"with E and F multiples of {_TILE}; got {fmt}, B={B}, E={E}, F={F}")
    with torch.cuda.device(dev):  # the launch goes to the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        if on_tc:
            err = lib.rwkv_decode_stack_tc(arr, len(table), L, B, E, F, prep.Vp, prep.tc_plan(B),
                                           prep.tc_maps, prep.tc_op_stages, partial.numel(),
                                           counters.numel(), stream, ctypes.byref(n),
                                           ctypes.byref(grid))
        else:
            halves = (ctypes.c_int * len(prep.halves))(*prep.halves)
            err = lib.rwkv_decode_stack(arr, len(table), L, B, E, F, prep.Vp, int(prep.q4),
                                        halves, block, partial.numel(), counters.numel(),
                                        stream, ctypes.byref(n), ctypes.byref(grid))
    if block:
        launches_a8 += n.value
    elif prep.q4:
        launches_q4 += n.value
    else:
        launches += n.value
    if on_tc:
        _count_tc(n.value)
    _build.check(lib, err, "decode_stack")
    return y, new_state, xs_h, off_h, buf["amax"][1] if block else None


def _count_tc(n: int) -> None:
    """Count n launches of the TC kernel: launches_tc and the registry's
    TC_COUNTER."""
    global launches_tc
    launches_tc += n
    if n:
        metrics.inc(TC_COUNTER, n)


def forward_step_fused(params: RWKVParams, token: torch.Tensor, state: WKVState, *,
                       a8: bool = False, head_a8: bool = False, a8_block: int | None = None
                       ) -> Tuple[torch.Tensor, WKVState]:
    """Full decode step on kernels K1 (layers) and K2 (head), in q4 on K4 and
    K3, with a8 on K5 (stack and head), + logit_bias.

    token: scalar (state leaves [L, E]) or [B] (state leaves [L, B, E]).
    a8: every matvec W8A8 (a8_block: see the module docstring); head_a8:
    only the head. Returns (logits [..., Vp], new state), as
    models.rwkv4.forward_step."""
    unbatched = token.dim() == 0
    tok = token.reshape(1) if unbatched else token
    st = WKVState(*(s[:, None] for s in state)) if unbatched else state
    _, new_state, xs_h, off_h, amax_h = _decode(params, tok, st, a8, a8_block)
    head = params.head
    if isinstance(head, Quant4Linear):
        if head_a8:
            raise ValueError("head_a8 needs an int8 head; this one is 4-bit")
        logits = mm4(xs_h, head.wp, block=head.block, row_add=off_h, col_add=params.logit_bias)
    elif a8 or head_a8:
        logits = mm8_a8(xs_h, head.w, row_add=off_h, col_add=params.logit_bias, amax=amax_h)
    else:
        logits = mm8(xs_h, head.w, row_add=off_h, col_add=params.logit_bias)
    if unbatched:
        return logits[0], WKVState(*(s[:, 0] for s in new_state))
    return logits, new_state
