"""One layer's halves on one tensor-parallel shard, kernel K6 (counterpart of
rwkv_tpu/ops/pallas/tp_halves.py).

    att_half(p, l, x, xy, aa, bb, pp, decay, bonus)
        -> (partial [B, E], aa', bb', pp' [B, El], xx [B, E])
    ffn_half(p, l, x, dd)
        -> (vpartial [B, E], gate [B, El], xx2 [B, E])

`p` is one shard's RWKVParams (parallel/sharding.py::shard_params): column
shards [L, E, El] of att key/value/receptance and ffn receptance and [L, E,
Fl] of ffn key, with replicated scale/offset [L, E]; row shards [L, El, E] of
att.output and [L, Fl, E] of ffn.value, with the shard's scale/offset slices
[L, El] and [L, Fl]. decay and bonus are the shard's channel slices [L, El];
x, xy, dd [B, E] and aa/bb/pp [B, El] are layer l's.

att_half: ln1 + token-shift mix, the column-parallel k/v/r on the shard's El
channels, the WKV step, and the row-parallel out-projection's PARTIAL, its
rank-1 offset share included. ffn_half: ln2 + mix, the gate sigmoid(r) on
the El channels, relu(key)^2 on the Fl channels, and the row-parallel value
partial. Both also return the new token-shift memory (xx = ln1(x), xx2 =
ln2(x)), which is the same on every shard. The caller sums the partials over
the shards and adds the residuals (parallel/tp_step.py): a sum of partials is
the partial of the sum. At tp = 1 (El = E, Fl = F) they are the whole layer
less its residual adds.

On CUDA tensors the wrappers launch csrc/tp_halves.cu or raise: 2 launches
a half, from one host call each (int8 weights, models.rwkv4.signedize_params),
each a thread-block-cluster launch with programmatic dependent launch
(csrc/cluster_qmv.cuh); launches_att and launches_ffn rise by 2 a call. On
CPU tensors they run att_half_plain and ffn_half_plain. Bound on the card:
the shard's weight bytes per layer over device memory bandwidth, 4 * E * El
(att) and 2 * E * Fl + E * El (ffn). `plan` says how each launch is cut.

Not ported: the JAX module's pick_tp_tile, a model of the TPU's VMEM.
"""

from __future__ import annotations

import ctypes

import torch

from rwkv_tpu_torch.models.rwkv4 import RWKVParams
from rwkv_tpu_torch.ops.cuda import _build
from rwkv_tpu_torch.ops.cuda.decode_stack import _get, _offset_term
from rwkv_tpu_torch.ops.layernorm import layer_norm
from rwkv_tpu_torch.ops.quant import QuantLinear
from rwkv_tpu_torch.ops.wkv import WKVChannelState, wkv_step

# kernel launches, for showing that a path ran on the kernel
launches_att = 0
launches_ffn = 0

_lib = None

# The pointer tables of rwkv_att_half() and rwkv_ffn_half(), in the order of
# `enum AttPtr` and `enum FfnPtr` in csrc/tp_halves.cu.
_ATT_POINTERS = (
    "x", "xy", "ln1.weight", "ln1.bias", "att.mix_k", "att.mix_v", "att.mix_r",
    "att.key.w", "att.key.scale", "att.key.offset",
    "att.value.w", "att.value.scale", "att.value.offset",
    "att.receptance.w", "att.receptance.scale", "att.receptance.offset",
    "att.output.w", "att.output.scale", "att.output.offset", "decay", "bonus",
    "aa", "bb", "pp", "partial", "aa_out", "bb_out", "pp_out", "xy_out", "rwkv",
)
_FFN_POINTERS = (
    "x", "dd", "ln2.weight", "ln2.bias", "ffn.mix_k", "ffn.mix_r",
    "ffn.key.w", "ffn.key.scale", "ffn.key.offset",
    "ffn.receptance.w", "ffn.receptance.scale", "ffn.receptance.offset",
    "ffn.value.w", "ffn.value.scale", "ffn.value.offset",
    "vpartial", "gate", "dd_out", "kk",
)
_ATT_PARAMS = tuple(n for n in _ATT_POINTERS if "." in n)
_FFN_PARAMS = tuple(n for n in _FFN_POINTERS if "." in n)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("tp_halves")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rwkv_att_half.argtypes = [ctypes.POINTER(P), I, I, I, I, I, P, ctypes.POINTER(I)]
        lib.rwkv_ffn_half.argtypes = [ctypes.POINTER(P), I, I, I, I, I, I, P, ctypes.POINTER(I)]
        lib.rwkv_halves_plan.argtypes = [I, I, I, I, I, ctypes.POINTER(I)]
        lib.rwkv_cuda_versions.argtypes = [ctypes.POINTER(I), ctypes.POINTER(I)]
        for fn in (lib.rwkv_att_half, lib.rwkv_ffn_half, lib.rwkv_att_half_pointer_count,
                   lib.rwkv_ffn_half_pointer_count, lib.rwkv_halves_plan,
                   lib.rwkv_cuda_versions):
            fn.restype = I
        if (lib.rwkv_att_half_pointer_count() != len(_ATT_POINTERS)
                or lib.rwkv_ffn_half_pointer_count() != len(_FFN_POINTERS)):
            raise RuntimeError("tp_halves.cu's pointer tables do not match this module's")
        _lib = lib
    return _lib


def _widths(p: RWKVParams):
    """(L, E, El, Fl) of a shard."""
    return p.n_layer, p.n_embd, p.att.key.out_features, p.ffn.key.out_features


def _shapes(L: int, E: int, El: int, Fl: int) -> dict:
    sh = {"ln1.weight": (L, E), "ln1.bias": (L, E), "ln2.weight": (L, E), "ln2.bias": (L, E)}
    for n in ("att.mix_k", "att.mix_v", "att.mix_r", "ffn.mix_k", "ffn.mix_r"):
        sh[n] = (L, E)
    for fam, (K, O) in {"att.key": (E, El), "att.value": (E, El), "att.receptance": (E, El),
                        "att.output": (El, E), "ffn.key": (E, Fl),
                        "ffn.receptance": (E, El), "ffn.value": (Fl, E)}.items():
        sh[fam + ".w"] = (L, K, O)
        sh[fam + ".scale"] = (L, K)
        sh[fam + ".offset"] = (L, K)
    return sh


def _check(t: torch.Tensor, name: str, dtype, device, shape) -> None:
    if t.device != device:
        raise ValueError(f"tp_halves: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        if dtype == torch.int8 and t.dtype == torch.uint8:
            raise TypeError(f"tp_halves: {name} is uint8; the kernel takes int8 "
                            "(models.rwkv4.signedize_params at load time)")
        raise TypeError(f"tp_halves: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"tp_halves: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"tp_halves: {name} must be contiguous")


class _Table:
    """The pointer table of one half for one shard and batch size. The
    parameter and scratch slots are filled once; a call fills the
    slots of its inputs and outputs (`dynamic`, in order) and passes the same
    array: the host builds no table per call. The C function copies the
    pointers into its launches before it returns."""

    def __init__(self, names, fixed: dict, dynamic):
        self.arr = (ctypes.c_void_p * len(names))(*(fixed.get(n) for n in names))
        self.slots = [names.index(n) for n in dynamic]
        self.n = len(names)
        self.launched = ctypes.c_int(0)

    def fill(self, tensors):
        arr = self.arr
        for i, t in zip(self.slots, tensors):
            arr[i] = t.data_ptr()
        return arr


_ATT_IO = ("x", "xy", "decay", "bonus", "aa", "bb", "pp",
           "partial", "aa_out", "bb_out", "pp_out", "xy_out")
_FFN_IO = ("x", "dd", "vpartial", "gate", "dd_out")


class _Prepared:
    """A shard's checked parameter pointers, and its pointer tables by batch
    size."""

    def __init__(self, p: RWKVParams):
        if not all(isinstance(_get(p, f), QuantLinear) for f in
                   ("att.key", "att.value", "att.receptance", "att.output", "ffn.key",
                    "ffn.value", "ffn.receptance")):
            raise TypeError("tp_halves: every matrix family must be an int8 QuantLinear")
        self.params = p
        self.device = p.emb.device
        L, E, El, Fl = _widths(p)
        if E % 16 or El % 16 or Fl % 16:
            raise ValueError(f"tp_halves: E ({E}), E_loc ({El}) and F_loc ({Fl}) must be "
                             "multiples of 16")
        shapes = _shapes(L, E, El, Fl)
        ptrs = {}
        for name in _ATT_PARAMS + _FFN_PARAMS:
            t = _get(p, name)
            dtype = torch.int8 if name.endswith(".w") else torch.float32
            _check(t, name, dtype, self.device, shapes[name])
            if dtype == torch.int8 and t.data_ptr() % 16:
                raise ValueError(f"tp_halves: {name} must be 16-byte aligned")
            ptrs[name] = t.data_ptr()
        self.ptrs = ptrs
        self.L, self.E, self.El, self.Fl = L, E, El, Fl
        self.tables: dict = {}

    def tables_for(self, B: int):
        """(att table, ffn table) for batch size B."""
        got = self.tables.get(B)
        if got is None:
            buf = _buffers(self.device, B, self.El, self.Fl)
            fixed = {**self.ptrs, **{n: t.data_ptr() for n, t in buf.items()}}
            got = self.tables[B] = (_Table(_ATT_POINTERS, fixed, _ATT_IO),
                                    _Table(_FFN_POINTERS, fixed, _FFN_IO))
        return got


_prepared: dict = {}
_scratch: dict = {}


def _prepare(p: RWKVParams) -> _Prepared:
    prep = _prepared.get(id(p))
    if prep is None or prep.params is not p:
        if len(_prepared) > 64:  # params of earlier engines: drop them all
            _prepared.clear()
        prep = _prepared[id(p)] = _Prepared(p)
    return prep


def _buffers(device, B: int, El: int, Fl: int) -> dict:
    """The halves' intermediates (a1 -> a2, f1 -> f2). Every shard of a mesh
    on `device` may share them: their launches run in order on one stream,
    and each writes only once the launch before it has finished (shards on
    concurrent streams would need a set each)."""
    key = (device, B, El, Fl)
    s = _scratch.get(key)
    if s is None:
        s = _scratch[key] = {"rwkv": torch.empty((B, El), dtype=torch.float32, device=device),
                             "kk": torch.empty((B, Fl), dtype=torch.float32, device=device)}
    return s


def _io(t: torch.Tensor, name: str, device, shape) -> None:
    """An input's check, in the few attribute reads the common case needs."""
    if (t.device != device or t.dtype != torch.float32 or t.shape != shape
            or not t.is_contiguous()):
        _check(t, name, torch.float32, device, shape)


def _qmm(x: torch.Tensor, lin: QuantLinear, l: int) -> torch.Tensor:
    """x @ layer l of lin, the rank-1 offset term summed in double as the
    kernel sums it."""
    return torch.matmul(x * lin.scale[l], lin.w[l].float()) + _offset_term(x, lin.offset[l])[:, None]


def att_half_plain(p: RWKVParams, l: int, x, xy, aa, bb, pp, decay, bonus):
    """The plain PyTorch version of att_half."""
    att = p.att
    xx = layer_norm(x, p.ln1.weight[l], p.ln1.bias[l])
    mk, mv, mr = att.mix_k[l], att.mix_v[l], att.mix_r[l]
    k = _qmm(mk * xx + (1 - mk) * xy, att.key, l)
    v = _qmm(mv * xx + (1 - mv) * xy, att.value, l)
    r = _qmm(mr * xx + (1 - mr) * xy, att.receptance, l)
    y, chan = wkv_step(k, v, WKVChannelState(aa, bb, pp), decay[l], bonus[l])
    partial = _qmm(torch.sigmoid(r) * y, att.output, l)
    return partial, chan.aa, chan.bb, chan.pp, xx


def ffn_half_plain(p: RWKVParams, l: int, x, dd):
    """The plain PyTorch version of ffn_half."""
    ffn = p.ffn
    xx2 = layer_norm(x, p.ln2.weight[l], p.ln2.bias[l])
    mk, mr = ffn.mix_k[l], ffn.mix_r[l]
    fk = mk * xx2 + (1 - mk) * dd
    fr = mr * xx2 + (1 - mr) * dd
    gate = torch.sigmoid(_qmm(fr, ffn.receptance, l))
    h = torch.square(torch.relu(_qmm(fk, ffn.key, l)))
    return _qmm(h, ffn.value, l), gate, xx2


def _launch(fn, table: _Table, tensors, dims, what: str, device) -> int:
    lib = _kernel()
    with torch.cuda.device(device):  # the launch goes to the current device
        err = fn(lib)(table.fill(tensors), table.n, *dims,
                      torch.cuda.current_stream(device).cuda_stream, ctypes.byref(table.launched))
    _build.check(lib, err, what)
    return table.launched.value


def att_half(p: RWKVParams, l: int, x, xy, aa, bb, pp, decay, bonus):
    """Layer l's att half on shard p; returns (partial, aa', bb', pp', xx)."""
    if p.emb.device.type == "cpu" and x.device.type == "cpu":
        return att_half_plain(p, l, x, xy, aa, bb, pp, decay, bonus)
    global launches_att
    prep = _prepare(p)
    dev = prep.device
    if dev.type != "cuda":
        raise ValueError(f"att_half runs on CUDA or CPU tensors, got {dev}")
    L, E, El = prep.L, prep.E, prep.El
    if not 0 <= l < L:
        raise IndexError(f"att_half: layer {l} of {L}")
    B = x.shape[0]
    be, bl = (B, E), (B, El)
    for name, t, shape in (("x", x, be), ("xy", xy, be), ("aa", aa, bl), ("bb", bb, bl),
                           ("pp", pp, bl), ("decay", decay, (L, El)), ("bonus", bonus, (L, El))):
        _io(t, name, dev, shape)
    att, _ = prep.tables_for(B)
    out = (torch.empty(be, dtype=torch.float32, device=dev), torch.empty_like(aa),
           torch.empty_like(bb), torch.empty_like(pp), torch.empty_like(xy))
    launches_att += _launch(lambda lib: lib.rwkv_att_half, att,
                            (x, xy, decay, bonus, aa, bb, pp) + out, (l, B, E, El), "att_half",
                            dev)
    return out


def ffn_half(p: RWKVParams, l: int, x, dd):
    """Layer l's ffn half on shard p; returns (vpartial, gate, xx2)."""
    if p.emb.device.type == "cpu" and x.device.type == "cpu":
        return ffn_half_plain(p, l, x, dd)
    global launches_ffn
    prep = _prepare(p)
    dev = prep.device
    if dev.type != "cuda":
        raise ValueError(f"ffn_half runs on CUDA or CPU tensors, got {dev}")
    L, E, El, Fl = prep.L, prep.E, prep.El, prep.Fl
    if not 0 <= l < L:
        raise IndexError(f"ffn_half: layer {l} of {L}")
    B = x.shape[0]
    _io(x, "x", dev, (B, E))
    _io(dd, "dd", dev, (B, E))
    _, ffn = prep.tables_for(B)
    out = (torch.empty((B, E), dtype=torch.float32, device=dev),
           torch.empty((B, El), dtype=torch.float32, device=dev), torch.empty_like(dd))
    launches_ffn += _launch(lambda lib: lib.rwkv_ffn_half, ffn, (x, dd) + out,
                            (l, B, E, El, Fl), "ffn_half", dev)
    return out


LAUNCHES = ("a1", "a2", "f1", "f2")  # in order: att_half's two, then ffn_half's


def plan(B: int, E: int, El: int, Fl: int, device=None) -> dict:
    """How each of the four launches is cut on the card at these widths:
    {launch: {"cluster", "blocks", "smem_bytes", "pass_rows",
    "active_clusters"}}; active_clusters is how many of its clusters the
    card holds at once (cudaOccupancyMaxActiveClusters), so blocks <=
    cluster * active_clusters means one wave. Launches nothing."""
    lib = _kernel()
    out = (ctypes.c_int * 5)()
    keys = ("cluster", "blocks", "smem_bytes", "pass_rows", "active_clusters")
    got = {}
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        for h, name in enumerate(LAUNCHES):
            _build.check(lib, lib.rwkv_halves_plan(h, B, E, El, Fl, out), f"plan {name}")
            got[name] = dict(zip(keys, out))
    return got


def cuda_versions() -> tuple:
    """(runtime, driver) CUDA versions as 1000 * major + 10 * minor, from
    the kernel library: programmatic dependent launch inside a CUDA graph
    needs 12.3 or later of both."""
    lib = _kernel()
    rt, drv = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib, lib.rwkv_cuda_versions(ctypes.byref(rt), ctypes.byref(drv)), "versions")
    return rt.value, drv.value
