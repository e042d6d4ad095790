"""One tensor-parallel decode step of every model shard of a data row,
kernel K7 (counterpart of rwkv_tpu/ops/pallas/decode_stack_tp.py).

    decode_stack_tp(shards, states, local, token=tokens [B])   (B <= 8)
    decode_stack_tp(shards, states, local, x=x [B, E])         x after ln0
        -> (logits_loc: tp tensors [B, Vp / tp], new states: tp WKVStates)

`shards` is one data row of parallel/sharding.py's ShardedParams
(`sp.rows[d]`), `states` each shard's state (xy/dd [L, B, E], aa/bb/pp
[L, B, E / tp]) and `local` each shard's (decay, bonus) channel slices
(`sp.local(d, j)`). The step runs every layer of every shard: the
vocab-sharded embedding gather and its sum over the shards + ln0 (with
`token`), ln1 + mix, the column-parallel k/v/r and the WKV step on each
shard's channels, the row-parallel out-projection partials and their sum,
ln2 + mix, each shard's gate and relu(key)^2, the value partials and the
residual x + gate * sum, then ln_out and each shard's head columns. The
logits carry no logit bias (as in the JAX kernel): the caller adds each
shard's slice and gathers them. The replicated xy/dd of the new states are
the same tensors for every shard.

On CUDA tensors the wrapper launches csrc/decode_stack_tp.cu. Where every
shard of the row lies on one device, the whole step of all the shards is one
persistent, cooperative launch (4 * L + 1 phases behind 4 * L grid barriers,
the grid the occupancy API's blocks per SM times the SMs: `stack_grid_tp`),
and the exchanges are sums of the shards' partials in shard order 0..tp-1
folded into the phases that read them. Where each shard lies on its own
card (`row_devices`), each card runs one cooperative launch of its own shard,
all enqueued from this thread, and the exchanges are peer stores over NVLink
into receive slots on every card, ordered by a flag per exchange and shard
(the source's note says how); the sums stay in shard order 0..tp-1, so the
step holds against the same plain version. Peer access between every pair of
the row's cards is checked once and enabled; a pair without it raises, naming
the pair. Each card's receive slots and flags are one region of its own
(`_region_layout`). Where the row's shards lie in distinct processes, one
card each (`mesh=`, a parallel/multihost.py pod mesh whose row spans
processes), each process launches its own shard's step, and the row's
processes open each other's regions through CUDA IPC (the source's note says
how; `release_ipc` closes and frees them); `process_row_problem` names why a
row cannot run so (processes sharing a card, a row across hosts, a pair of
cards without peer access), and the first call on such a row raises it. A
launch a card refuses raises; there is no other route. `stamps=`
takes an int64 CUDA tensor of at least 4 * L + 2 entries (6 * L + 3 across
cards: one tensor per card, a list), into which the kernel writes
%globaltimer at its start, after each barrier and at its end, and across
cards at the end of each exchange's wait (tools/decode_profile.py reads the
time of each phase and the exchanges' share). On CPU tensors it runs `decode_stack_tp_reference`, which does the
exchanges as the same explicit sums (across processes, this process's shards
first, then the mesh's collectives over the row's group). Weights: signed int8
(models.rwkv4.signedize_params) or, in q4, every family Quant4Linear, with
att.output and ffn.value packed in blocks that divide E / tp and F / tp.
Bound on the card: the weight bytes of
all shards per step over device memory bandwidth (379 MB in q8, 189.5 MB in
q4 at 430M: 0.113 and 0.057 ms at 3.35 TB/s); across cards, each card's own
shard's bytes over that bandwidth, plus 3 L + 1 exchange latencies.

Not ported: the JAX module's pick_tp_fused_tile and pick_tp_head_tile, models
of the TPU's VMEM, and its 4-D pretiled weight layout.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch.distributed as dist

import torch

from rwkv_tpu_torch.models.rwkv4 import RWKVParams, WKVState
from rwkv_tpu_torch.ops.cuda import _build
from rwkv_tpu_torch.ops.cuda.decode_stack import _get, _offset_term
from rwkv_tpu_torch.ops.cuda.mm4 import block_half
from rwkv_tpu_torch.ops.layernorm import layer_norm
from rwkv_tpu_torch.ops.quant import Quant4Linear, QuantLinear, unpack4
from rwkv_tpu_torch.ops.wkv import WKVChannelState, wkv_step

# kernel launches, for showing that a path ran on the kernel: q8, q4; one
# per step, across cards one per card a step
launches = 0
launches_q4 = 0

MAX_SHARDS = 8    # csrc/qmv.cuh's kMaxShards: one launch's shards
FUSE_EMBED_MAX_B = 8  # the embedding gather rides in the step up to this batch
_BARRIER_WORDS = 64   # csrc/grid.cuh's kBarrierWords, after the shards' counters
_FLAG_WORDS = 64      # csrc/decode_stack_tp.cu's kFlagWords (across cards)
_COUNTERS = 4096      # split-K counters a shard (phase D's two families: half each)

_lib = None

# The pointer table of rwkv_decode_stack_tp(): the data row's pointers in the
# order of `enum SharedPtr` in csrc/decode_stack_tp.cu, then one block per
# shard in the order of `enum ShardPtr` (tests/test_torch_kernel_tables.py
# holds each tuple against its enum).
_SHARED = (
    "tokens", "x_in", "x", "x_mid", "xy_in", "dd_in", "xy_out", "dd_out", "apart", "vpart",
    "gate", "rwkv", "kk", "fr", "fr_off", "off_parts", "logits", "partial", "counters",
    "stamps", "emb_slots", "flags", "peers",
)
# Across cards, the table at "peers" holds, per kind and card c, the address
# on card c of this shard's receive slot (or card c's flag words), in the
# order of `enum PeerKind`.
_PEER_KINDS = ("apart", "vpart", "gate", "emb", "flags")
_SHARD = (
    "emb", "ln0.weight", "ln0.bias", "ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias",
    "att.mix_k", "att.mix_v", "att.mix_r", "ffn.mix_k", "ffn.mix_r",
    "att.key.w", "att.key.scale", "att.key.offset",
    "att.value.w", "att.value.scale", "att.value.offset",
    "att.receptance.w", "att.receptance.scale", "att.receptance.offset",
    "att.output.w", "att.output.scale", "att.output.offset",
    "ffn.key.w", "ffn.key.scale", "ffn.key.offset",
    "ffn.value.w", "ffn.value.scale", "ffn.value.offset",
    "ffn.receptance.w", "ffn.receptance.scale", "ffn.receptance.offset",
    "ln_out.weight", "ln_out.bias", "head.w", "head.scale", "head.offset",
    "decay", "bonus", "aa", "bb", "pp", "aa_out", "bb_out", "pp_out",
)
_SHARD_PARAMS = _SHARD[:_SHARD.index("decay")]
_SHARD_IO = _SHARD[_SHARD.index("decay"):]
# The matrix families in the order of rwkv_decode_stack_tp()'s halves[]; the
# row-parallel ones pair 4-bit rows within a block that lies inside a shard.
_FAMILIES = ("att.key", "att.value", "att.receptance", "att.output",
             "ffn.key", "ffn.value", "ffn.receptance", "head")
_ROW_PARALLEL = ("att.output", "ffn.value")


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("decode_stack_tp")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rwkv_decode_stack_tp.argtypes = [ctypes.POINTER(P), I, I, I, I, I, I, I, I, I, I,
                                             I, I, ctypes.POINTER(I), ctypes.c_longlong, I, P,
                                             ctypes.POINTER(I), ctypes.POINTER(I)]
        lib.rwkv_decode_stack_tp_grid.argtypes = [I, I, I, ctypes.POINTER(I)]
        lib.rwkv_enable_peer.argtypes = [I, I]
        lib.rwkv_ipc_alloc.argtypes = [ctypes.c_longlong, ctypes.POINTER(P), P]
        lib.rwkv_ipc_open.argtypes = [P, ctypes.POINTER(P)]
        lib.rwkv_ipc_close.argtypes = [P]
        lib.rwkv_ipc_free.argtypes = [P]
        for fn in (lib.rwkv_ipc_alloc, lib.rwkv_ipc_open, lib.rwkv_ipc_close,
                   lib.rwkv_ipc_free, lib.rwkv_ipc_handle_bytes,
                   lib.rwkv_decode_stack_tp, lib.rwkv_decode_stack_tp_grid,
                   lib.rwkv_decode_stack_tp_shared_count, lib.rwkv_decode_stack_tp_shard_count,
                   lib.rwkv_decode_stack_tp_max_shards, lib.rwkv_decode_stack_tp_barrier_words,
                   lib.rwkv_decode_stack_tp_flag_words, lib.rwkv_decode_stack_tp_peer_kinds,
                   lib.rwkv_enable_peer):
            fn.restype = I
        if (lib.rwkv_decode_stack_tp_shared_count() != len(_SHARED)
                or lib.rwkv_decode_stack_tp_shard_count() != len(_SHARD)
                or lib.rwkv_decode_stack_tp_max_shards() != MAX_SHARDS
                or lib.rwkv_decode_stack_tp_barrier_words() != _BARRIER_WORDS
                or lib.rwkv_decode_stack_tp_flag_words() != _FLAG_WORDS
                or lib.rwkv_decode_stack_tp_peer_kinds() != len(_PEER_KINDS)):
            raise RuntimeError("decode_stack_tp.cu's pointer tables do not match this module's")
        _lib = lib
    return _lib


def fused_problem(p: RWKVParams, tp: int, E: int, F: int, V: int):
    """Why kernel K7 cannot run params shaped like `p` (a shard, or the whole
    params) over `tp` model shards with whole widths E, F and padded vocab V:
    (exception class, message), or None. The JAX kernel's checks: signed int8
    or all-Quant4Linear families, E / tp a multiple of 128, each shard's
    vocab a multiple of 128, and, in q4, the row-parallel pack blocks inside
    a shard (the port has no VMEM tile model, so the block need not equal a
    tile: it must divide E / tp and F / tp)."""
    fams = {f: _get(p, f) for f in _FAMILIES}
    q4 = isinstance(p.att.key, Quant4Linear)
    if q4:
        bad = [f for f, lin in fams.items() if not isinstance(lin, Quant4Linear)]
        if bad:
            return TypeError, (f"4-bit tensor-parallel decode needs every matrix family "
                               f"Quant4Linear; {', '.join(bad)} are not "
                               "(models.rwkv4.quantize_params_q4)")
    elif not all(isinstance(lin, QuantLinear) and lin.w.dtype == torch.int8
                 for lin in fams.values()):
        return TypeError, ("decode_stack_tp needs signed int8 QuantLinear weights "
                           "(models.rwkv4.signedize_params) or 4-bit Quant4Linear ones")
    if not 1 <= tp <= MAX_SHARDS:
        return ValueError, f"decode_stack_tp runs 1 to {MAX_SHARDS} model shards, got {tp}"
    if E % tp or (E // tp) % 128:
        return ValueError, f"decode_stack_tp needs E/tp a multiple of 128 (E={E}, tp={tp})"
    if V % tp or (V // tp) % 128:
        return ValueError, (f"local vocab shard {V}/{tp} is not a multiple of 128; pad the "
                            "vocab to a multiple of 128*tp (models.rwkv4.pad_vocab)")
    if q4:
        for f, lin in fams.items():
            if f not in _ROW_PARALLEL and lin.block is not None:
                return ValueError, (f"4-bit column-parallel family {f} must pair globally "
                                    f"(block None), got block {lin.block}")
        for f, K in (("att.output", E), ("ffn.value", F)):
            b = fams[f].block or K
            if (K // tp) % b:
                return ValueError, (f"4-bit {f} is packed in blocks of {b} rows, which do "
                                    f"not divide its {K // tp} rows per shard at model={tp}; "
                                    "requantize with quantize_params_q4(tile="
                                    "models.rwkv4.q4_pack_block(E, tp))")
    return None


def _meta(shards: Sequence[RWKVParams], tp: Optional[int] = None):
    """(L, E, El, Fl, Vl, q4) of a data row's shards (tp of them, default
    all given), after the JAX kernel's checks."""
    p0, tp = shards[0], tp or len(shards)
    q4 = isinstance(p0.att.key, Quant4Linear)
    El, Fl = p0.att.key.out_features, p0.ffn.key.out_features
    Vl = p0.head.out_features
    E = p0.n_embd
    problem = fused_problem(p0, tp, El * tp, Fl * tp, Vl * tp)
    if problem is None and El * tp != E:
        problem = ValueError, f"a shard's {El} channels times {tp} shards is not E={E}"
    if problem is not None:
        raise problem[0](problem[1])
    return p0.n_layer, E, El, Fl, Vl, q4


def _qmm(x: torch.Tensor, lin, l: Optional[int] = None) -> torch.Tensor:
    """x @ (layer l of) lin, q8 or q4, the rank-1 offset term summed in
    double as the kernels sum it."""
    pick = (lambda t: t) if l is None else (lambda t: t[l])  # noqa: E731
    if isinstance(lin, Quant4Linear):
        w = unpack4(pick(lin.wp), lin.block).float()
    else:
        w = pick(lin.w).float()
    return torch.matmul(x * pick(lin.scale), w) + _offset_term(x, pick(lin.offset))[:, None]


def _in_order(parts):
    """parts[0] + parts[1] + ... in shard order, as the exchanges sum them."""
    s = parts[0]
    for t in parts[1:]:
        s = s + t
    return s


class _Exchange:
    """The exchanges of the plain version: sums of the shards' partials in
    shard order and the gates' concatenation; for a row across processes
    (mesh), this process's shards first, then the row's group (the mesh's
    group_sum and group_gather, not counted as the step's collectives: they
    stand for the kernel's peer stores)."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.first = 0 if mesh is None else mesh.first_shard

    def sum(self, parts):
        s = _in_order(parts)
        return s if self.mesh is None else self.mesh.group_sum(s)

    def cat(self, parts):
        g = torch.cat(parts, dim=-1)
        return g if self.mesh is None else self.mesh.group_gather(g, -1)


def _embed(shards, token: torch.Tensor, ex: _Exchange) -> torch.Tensor:
    """The vocab-sharded gather: shard j holds rows [j * Vl, (j + 1) * Vl); a
    row outside every shard is zero; summed in shard order, then ln0."""
    rows = []
    for j, p in enumerate(shards):
        Vl = p.emb.shape[0]
        t = token.long() - (ex.first + j) * Vl
        mine = ((t >= 0) & (t < Vl))[:, None]
        got = p.emb[t.clamp(0, Vl - 1)]
        rows.append(torch.where(mine, got, torch.zeros_like(got)))
    p0 = shards[0]
    return layer_norm(ex.sum(rows), p0.ln0.weight, p0.ln0.bias)


def decode_stack_tp_reference(shards: Sequence[RWKVParams], states: Sequence[WKVState],
                              local, *, x: Optional[torch.Tensor] = None,
                              token: Optional[torch.Tensor] = None, mesh=None):
    """The plain PyTorch version of decode_stack_tp: the same step, shard by
    shard, the exchanges as explicit sums in shard order 0..tp-1. mesh: a
    pod mesh whose row spans processes; `shards` are then this process's
    (global shards mesh.first_shard on), and the exchanges also run over the
    row's group, so every process of the row calls it at once."""
    shards = list(shards)
    _meta(shards, None if mesh is None else mesh.shape["model"])
    ex = _Exchange(mesh)
    p0 = shards[0]
    if (x is None) == (token is None):
        raise ValueError("decode_stack_tp takes exactly one of x and token")
    if token is not None:
        if token.shape[0] > FUSE_EMBED_MAX_B:
            raise ValueError(f"decode_stack_tp's embedding gather takes B <= "
                             f"{FUSE_EMBED_MAX_B}; pass x for more")
        x = _embed(shards, token, ex)
    new = [[] for _ in shards]
    for i in range(p0.n_layer):
        att = p0.att
        xx = layer_norm(x, p0.ln1.weight[i], p0.ln1.bias[i])
        xy = states[0].xy[i]
        ik = att.mix_k[i] * xx + (1 - att.mix_k[i]) * xy
        iv = att.mix_v[i] * xx + (1 - att.mix_v[i]) * xy
        ir = att.mix_r[i] * xx + (1 - att.mix_r[i]) * xy
        parts, chans = [], []
        for p, st, (decay, bonus) in zip(shards, states, local):
            k, v, r = _qmm(ik, p.att.key, i), _qmm(iv, p.att.value, i), _qmm(ir, p.att.receptance, i)
            y, chan = wkv_step(k, v, WKVChannelState(st.aa[i], st.bb[i], st.pp[i]), decay[i],
                               bonus[i])
            parts.append(_qmm(torch.sigmoid(r) * y, p.att.output, i))
            chans.append(chan)
        x = x + ex.sum(parts)
        ffn = p0.ffn
        xx2 = layer_norm(x, p0.ln2.weight[i], p0.ln2.bias[i])
        dd = states[0].dd[i]
        fk = ffn.mix_k[i] * xx2 + (1 - ffn.mix_k[i]) * dd
        fr = ffn.mix_r[i] * xx2 + (1 - ffn.mix_r[i]) * dd
        gates, vparts = [], []
        for p in shards:
            gates.append(torch.sigmoid(_qmm(fr, p.ffn.receptance, i)))
            h = torch.square(torch.relu(_qmm(fk, p.ffn.key, i)))
            vparts.append(_qmm(h, p.ffn.value, i))
        x = x + ex.cat(gates) * ex.sum(vparts)
        for j, chan in enumerate(chans):
            new[j].append((xx, chan.aa, chan.bb, chan.pp, xx2))
    h = layer_norm(x, p0.ln_out.weight, p0.ln_out.bias)
    xs_h, off_h = h * p0.head.scale, _offset_term(h, p0.head.offset)
    logits = []
    for p in shards:
        head = p.head
        w = unpack4(head.wp, head.block) if isinstance(head, Quant4Linear) else head.w
        logits.append(torch.matmul(xs_h, w.float()) + off_h[:, None])
    xy, dd = torch.stack([n[0] for n in new[0]]), torch.stack([n[4] for n in new[0]])
    return logits, [WKVState(xy, *(torch.stack([n[k] for n in layers]) for k in (1, 2, 3)), dd)
                    for layers in new]


def _check(t: torch.Tensor, name: str, dtype, device, shape) -> None:
    if t.device != device:
        raise ValueError(f"decode_stack_tp: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"decode_stack_tp: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"decode_stack_tp: {name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"decode_stack_tp: {name} must be contiguous")


def _io(t: torch.Tensor, name: str, device, shape) -> None:
    """An input's check, in the few attribute reads the common case needs."""
    if (t.device != device or t.dtype != torch.float32 or t.shape != shape
            or not t.is_contiguous()):
        _check(t, name, torch.float32, device, shape)


def _param_shapes(L, E, El, Fl, Vl, n_emb, q4) -> dict:
    h = 2 if q4 else 1
    sh = {"emb": (n_emb, E), "ln0.weight": (E,), "ln0.bias": (E,), "ln_out.weight": (E,),
          "ln_out.bias": (E,), "head.w": (E // h, Vl), "head.scale": (E,), "head.offset": (E,)}
    for n in ("ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias", "att.mix_k", "att.mix_v",
              "att.mix_r", "ffn.mix_k", "ffn.mix_r"):
        sh[n] = (L, E)
    for fam, (K, O) in {"att.key": (E, El), "att.value": (E, El), "att.receptance": (E, El),
                        "att.output": (El, E), "ffn.key": (E, Fl), "ffn.value": (Fl, E),
                        "ffn.receptance": (E, El)}.items():
        sh[fam + ".w"] = (L, K // h, O)
        sh[fam + ".scale"] = (L, K)
        sh[fam + ".offset"] = (L, K)
    return sh


def row_devices(devices) -> tuple[list, bool]:
    """(the CUDA devices a data row's shards run on, across cards): one
    device for the whole row, or, across cards, each shard's own card, with
    peer access between every pair. Raises for a row on the CPU, a row that
    repeats a card but not on one card only, and a pair of cards without peer
    access (named)."""
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"decode_stack_tp runs on CUDA devices; the row lies on "
                         f"{[str(d) for d in devs]}")
    if len(set(devs)) == 1:
        return devs[:1], False
    if len(set(devs)) != len(devs):
        raise ValueError(f"decode_stack_tp runs a data row's shards on one device or each on "
                         f"its own card; this row names {[str(d) for d in devs]}")
    for a in devs:
        for b in devs:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(
                    f"decode_stack_tp across cards needs peer access between every pair of "
                    f"the row's cards; {a} cannot access {b} (cudaDeviceCanAccessPeer)")
    return devs, True


def process_row_problem(mesh):
    """Why kernel K7 cannot run this process's row across processes:
    (exception class, message), or None. It runs one shard a process, each
    process on its own CUDA card of one host, with peer access between
    every pair of the row's cards, from the cards pod_mesh gathered
    (mesh.row_cards: the same answer in every process of the row)."""
    cards = mesh.row_cards
    if cards is None:
        return RuntimeError, ("decode_stack_tp across processes needs the row's cards; build "
                              "the mesh with multihost.pod_mesh inside a process group")
    if any(c[1] != "cuda" for c in cards):
        return ValueError, (f"decode_stack_tp runs on CUDA devices; the row lies on "
                            f"{[f'{c[1]}:{c[2]}' for c in cards]}")
    if mesh.local_shards != 1:
        return ValueError, (f"decode_stack_tp across processes runs one shard a process; this "
                            f"process holds {mesh.local_shards} of the row's "
                            f"{mesh.shape['model']}")
    hosts = sorted({c[0] for c in cards})
    if len(hosts) > 1:
        return ValueError, (f"decode_stack_tp across processes runs a row on one host (CUDA "
                            f"IPC and peer stores do not cross hosts); this row spans {hosts}; "
                            "take body 'halves' or 'plain'")
    ids = [c[3] for c in cards]
    if len(set(ids)) != len(ids):
        shared = sorted({f"cuda:{c[2]}" for c in cards if ids.count(c[3]) > 1})
        return ValueError, (f"decode_stack_tp across processes: the row's processes share one "
                            f"card ({', '.join(shared)}); without MPS the cooperative launches "
                            f"of two processes do not run side by side on one card, and one "
                            f"would spin on the other's flag until its 20 s wait traps; take "
                            f"body 'halves' or 'plain'")
    visible = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        visible[str(getattr(torch.cuda.get_device_properties(i), "uuid", i))] = i
    index = [visible.get(c[3], c[2]) for c in cards]
    for a in index:
        for b in index:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                return RuntimeError, (
                    f"decode_stack_tp across processes needs peer access between every pair "
                    f"of the row's cards; cuda:{a} cannot access cuda:{b} "
                    f"(cudaDeviceCanAccessPeer)")
    return None


_peers_enabled: set = set()

# K7's regions across processes, each (its card, its address, the peers'
# mapped addresses, the row's group), in the order they were made
_ipc_regions: list = []


def open_handles() -> int:
    """Peer regions this process holds open (cudaIpcOpenMemHandle)."""
    return sum(len(r[2]) for r in _ipc_regions)


def _ipc_region(dev: torch.device, nbytes: int, mesh) -> list:
    """This card's region of `nbytes`, zeroed, and every shard's region of
    the row, opened here: [the address on this process of shard c's region
    for each shard c]. A collective of the row's processes: the handles are
    all-gathered over its group, and the row meets at a barrier once every
    process has opened its peers', before any launch."""
    lib = _kernel()
    group = mesh.model_group
    base = ctypes.c_void_p(0)
    handle = ctypes.create_string_buffer(lib.rwkv_ipc_handle_bytes())
    with torch.cuda.device(dev):
        _build.check(lib, lib.rwkv_ipc_alloc(nbytes, ctypes.byref(base), handle),
                     f"decode_stack_tp: the receive region on {dev}")
        got: list = [None] * dist.get_world_size(group)
        dist.all_gather_object(got, handle.raw, group=group)
    me = mesh.first_shard
    addrs, opened = [], []
    try:
        for c, h in enumerate(got):
            if c == me:
                addrs.append(base.value)
                continue
            ptr = ctypes.c_void_p(0)
            with torch.cuda.device(dev):
                _build.check(lib, lib.rwkv_ipc_open(h, ctypes.byref(ptr)),
                             f"decode_stack_tp: opening shard {c}'s region on {dev}")
            addrs.append(ptr.value)
            opened.append(ptr.value)
    finally:
        _ipc_regions.append((dev, base.value, opened, group))
    dist.barrier(group=group, device_ids=[dev.index])
    return addrs


def release_ipc() -> None:
    """Close and free K7's regions across processes, a collective of each
    row's processes (every process of the row calls it): each closes its
    peers' mappings, the row meets at a barrier, then each frees its own
    region, so no exporter frees a region another process still maps. The
    steps that used them must not run again."""
    lib = _kernel() if _ipc_regions else None
    regions = list(_ipc_regions)
    _ipc_regions.clear()
    for dev, _, opened, _ in regions:
        with torch.cuda.device(dev):
            torch.cuda.synchronize(dev)
            for ptr in opened:
                _build.check(lib, lib.rwkv_ipc_close(ptr), f"decode_stack_tp: closing a peer "
                             f"region on {dev}")
    for group in {id(r[3]): r[3] for r in regions}.values():
        dist.barrier(group=group, device_ids=[regions[0][0].index])
    for dev, base, _, _ in regions:
        with torch.cuda.device(dev):
            _build.check(lib, lib.rwkv_ipc_free(base), f"decode_stack_tp: freeing the region "
                         f"on {dev}")
    _prepared.clear()


def _enable_peers(devs) -> None:
    """Peer access from every card of the row to every other, once."""
    lib = _kernel()
    for a in devs:
        for b in devs:
            if a != b and (a.index, b.index) not in _peers_enabled:
                _build.check(lib, lib.rwkv_enable_peer(a.index, b.index),
                             f"decode_stack_tp: peer access {a} -> {b}")
                _peers_enabled.add((a.index, b.index))


class _Prepared:
    """A data row's checked parameter pointers, scratch and pointer tables by
    batch size: one table for a row on one device, one per card across
    cards. A table's parameter and scratch slots are filled once; a call
    fills the slots of its inputs and outputs and passes the same array."""

    def __init__(self, shards, mesh=None):
        self.shards = shards
        self.mesh = mesh  # a row across processes: this process's one shard
        if mesh is not None:
            problem = process_row_problem(mesh)
            if problem is not None:
                raise problem[0](problem[1])
            tp, devs, self.cards = mesh.shape["model"], [shards[0].emb.device], True
        else:
            tp = len(shards)
            devs, self.cards = row_devices([p.emb.device for p in shards])
            if self.cards:
                _enable_peers(devs)
        L, E, El, Fl, Vl, q4 = _meta(shards, tp)
        n_emb = shards[0].emb.shape[0]
        shapes = _param_shapes(L, E, El, Fl, Vl, n_emb, q4)
        ptrs = []
        for j, p in enumerate(shards):
            dev = devs[j] if self.cards else devs[0]
            for name in _SHARD_PARAMS:
                t = _get(p, name[:-2] + ".wp" if q4 and name.endswith(".w") else name)
                dtype = torch.int8 if name.endswith(".w") else torch.float32
                _check(t, f"shard {j} {name}", dtype, dev, shapes[name])
                if dtype == torch.int8 and t.data_ptr() % 16:
                    raise ValueError(f"decode_stack_tp: shard {j} {name} must be 16-byte aligned")
                ptrs.append(t.data_ptr())
        halves = [block_half(_get(shards[0], f).block, K, f"decode_stack_tp: {f}") if q4 else 0
                  for f, K in zip(_FAMILIES, (E, E, E, El, E, Fl, E, E))]
        self.halves = (ctypes.c_int * len(halves))(*halves)
        self.param_ptrs = ptrs
        self.devices, self.tp, self.q4 = devs, tp, q4
        self.device = devs[0]
        self.dims = (L, E, El, Fl, Vl, n_emb)
        self.tables: dict = {}
        self.slots: dict = {}  # across cards, by B: each launch's receive slots and flags

    def shard_device(self, j: int) -> torch.device:
        return self.devices[j] if self.cards else self.devices[0]

    def me(self, c: int) -> int:
        """The global shard index of launch c (`me` in the kernel)."""
        if self.mesh is not None:
            return self.mesh.first_shard
        return c if self.cards else 0

    def _regions(self, B: int, launches_) -> tuple[dict, list]:
        """Across cards: one region a card (_region_layout), its base on
        this process for every shard of the row: each card's own buffer in
        one process, or, across processes, this card's region and its
        peers' opened through CUDA IPC (a collective of the row)."""
        L, E, El, Fl, Vl, _ = self.dims
        lay = _region_layout(self.tp, B, E, El)
        if self.mesh is not None:
            return lay, _ipc_region(self.device, lay["total"][0], self.mesh)
        for dev, _, buf in launches_:  # zero on every card before any launch
            buf["region"] = torch.zeros(lay["total"][0], dtype=torch.uint8, device=dev)
        return lay, [buf["region"].data_ptr() for _, _, buf in launches_]

    def table(self, B: int):
        """[(pointer array, split-K partial floats a shard, its buffers) per
        launch] for batch size B, the scratch kept beside it. Each shard's
        partials hold a phase's splits when the grid holds one item a block
        (csrc/stack.cuh's stack_split): at most 3 matrices x B rows x 128
        columns a block. Across cards every card's table is made, and its
        grid asked for (which loads the kernel there), before any launch: a
        card's launch then spins on its peers' flags for microseconds, not
        for a peer's first-use set-up."""
        got = self.tables.get(B)
        if got is not None:
            return got
        L, E, El, Fl, Vl, _ = self.dims
        tp = self.tp
        nloc = 1 if self.cards else tp
        m = len(_SHARD_PARAMS)
        launches_ = []
        for c, dev in enumerate(self.devices):
            with torch.cuda.device(dev):
                grid = stack_grid_tp(B, E, q4=self.q4)
            z = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
            tiles = -(-El // 128) + -(-Fl // 128)  # column tiles of 128 (csrc/qmv.cuh)
            cap = min(3 * B * 128 * grid, _build.SPLIT_FLOATS)
            buf = {"x": z(B, E), "x_mid": z(B, E), "rwkv": z(nloc, B, El), "kk": z(nloc, B, Fl),
                   "fr": z(B, E),
                   # the rank-1 offset terms are summed in double
                   "fr_off": z(B).double(), "off_parts": z(nloc, tiles, B).double(),
                   "partial": z(nloc, cap),
                   # zero before the first launch; every launch leaves them so
                   "counters": torch.zeros(nloc * _COUNTERS + _BARRIER_WORDS, dtype=torch.int32,
                                           device=dev)}
            if not self.cards:
                buf.update(apart=z(tp, B, E), vpart=z(tp, B, E), gate=z(tp, B, El))
            launches_.append((dev, cap, buf))
        slots = [{} for _ in launches_]
        if self.cards:  # each card's receive slots, flags and table of its peers' slots
            lay, bases = self._regions(B, launches_)
            for c, (dev, _, buf) in enumerate(launches_):
                me = self.me(c)
                slots[c] = {name: bases[me] + lay[kind][0] for name, kind in
                            (("apart", "apart"), ("vpart", "vpart"), ("gate", "gate"),
                             ("emb_slots", "emb"), ("flags", "flags"))}
                addr = [[0] * MAX_SHARDS for _ in _PEER_KINDS]
                for k, kind in enumerate(_PEER_KINDS):
                    off, slot = lay[kind]
                    for d, base in enumerate(bases):
                        addr[k][d] = base + off + (0 if kind == "flags" else me * slot)
                buf["peers"] = torch.tensor(addr, dtype=torch.int64).to(dev)
            for dev, _, _ in launches_:
                torch.cuda.synchronize(dev)  # every card's zeros and tables in place
        self.slots[B] = slots
        got = []
        for c, (dev, cap, buf) in enumerate(launches_):
            fixed = {n: t.data_ptr() for n, t in buf.items()}
            fixed.update(slots[c])
            arr = (ctypes.c_void_p * (len(_SHARED) + nloc * len(_SHARD)))(
                *(fixed.get(n) for n in _SHARED))
            for j in range(nloc):
                base = len(_SHARED) + j * len(_SHARD)
                src = (c if self.cards else j) * m
                arr[base:base + m] = self.param_ptrs[src:src + m]
            got.append((arr, cap, buf))
        self.tables[B] = got
        return got


def _region_layout(tp: int, B: int, E: int, El: int) -> dict:
    """{kind: (byte offset, bytes of one shard's slot)} of a card's region
    across cards: apart, vpart, gate and the embedding slots, tp slots each,
    then the flag words (the step counter at word 0); offsets 256-byte
    aligned."""
    out, at = {}, 0
    for kind, n in (("apart", B * E), ("vpart", B * E), ("gate", B * El), ("emb", B * E)):
        out[kind] = (at, 4 * n)
        at += -(-4 * n * tp // 256) * 256
    out["flags"] = (at, 8 * _FLAG_WORDS)
    out["total"] = (at + 8 * _FLAG_WORDS, 0)
    return out


def stack_grid_tp(B: int, E: int, *, q4: bool = False) -> int:
    """Blocks of the step's cooperative launch on the current CUDA device at
    batch B and width E: the occupancy API's blocks per SM times the SMs."""
    lib = _kernel()
    g = ctypes.c_int(0)
    _build.check(lib, lib.rwkv_decode_stack_tp_grid(B, E, int(q4), ctypes.byref(g)),
                 "decode_stack_tp grid")
    return g.value


_prepared: dict = {}


def _prepare(shards, mesh=None) -> _Prepared:
    key = tuple(id(p) for p in shards) + (id(mesh),)
    prep = _prepared.get(key)
    if prep is None or any(a is not b for a, b in zip(prep.shards, shards)):
        if len(_prepared) > 64:  # earlier engines' rows, but those holding IPC regions
            for k in [k for k, v in _prepared.items() if v.mesh is None]:
                del _prepared[k]
        prep = _prepared[key] = _Prepared(list(shards), mesh)
    return prep


class _DeviceWords:
    """A view of device memory this module owns (a region across processes)
    for torch.as_tensor: [n] int64 at `ptr`."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": "<i8", "data": (ptr, False),
                                         "version": 3}


def flag_words(shards, B: int, mesh) -> torch.Tensor:
    """The flag words of K7's table at batch B on this process's card, for
    a row across processes (`mesh`), as an int64 tensor [64] on the host:
    word 0 the card's step counter (the launches it ran), then the flag of
    (exchange x, shard j) at 16 + 8 x + j (x: the embedding, att and ffn
    exchanges), each the epoch of its last release."""
    prep = _prepare(shards, mesh)
    prep.table(B)
    with torch.cuda.device(prep.device):
        torch.cuda.synchronize(prep.device)
        words = torch.as_tensor(_DeviceWords(prep.slots[B][0]["flags"], _FLAG_WORDS),
                                device=prep.device)
        return words.cpu()


_S = {n: i for i, n in enumerate(_SHARED)}
_D = {n: i for i, n in enumerate(_SHARD)}


def decode_stack_tp(shards: Sequence[RWKVParams], states: Sequence[WKVState], local, *,
                    x: Optional[torch.Tensor] = None, token: Optional[torch.Tensor] = None,
                    stamps=None, mesh=None):
    """One decode step of the shards of a data row; returns (logits_loc, new
    states) as decode_stack_tp_reference, each shard's on its device. token
    [B] (B <= 8) or x [B, E], on any of the row's devices. stamps: see the
    module docstring (CUDA only). mesh: a pod mesh whose row spans
    processes; `shards`, `states` and `local` are then this process's one
    shard's, and every process of the row calls this at once."""
    if mesh is not None and not mesh.spans_processes:
        mesh = None
    given = token if x is None else x
    if shards[0].emb.device.type == "cpu" and given is not None and given.device.type == "cpu":
        return decode_stack_tp_reference(shards, states, local, x=x, token=token, mesh=mesh)
    global launches, launches_q4
    prep = _prepare(shards, mesh)
    tp = prep.tp
    n_here = len(prep.shards)
    L, E, El, Fl, Vl, n_emb = prep.dims
    if (x is None) == (token is None):
        raise ValueError("decode_stack_tp takes exactly one of x and token")
    if len(states) != n_here or len(local) != n_here:
        raise ValueError(f"decode_stack_tp: {len(states)} states and {len(local)} (decay, "
                         f"bonus) pairs for {n_here} shards")
    row = set(prep.devices)
    if token is not None:
        if token.dim() != 1 or token.device not in row:
            raise ValueError(f"decode_stack_tp: token must be [B] on one of "
                             f"{sorted(map(str, row))}, got {tuple(token.shape)} on "
                             f"{token.device}")
        B = token.shape[0]
        if B > FUSE_EMBED_MAX_B:
            raise ValueError(f"decode_stack_tp's embedding gather takes B <= "
                             f"{FUSE_EMBED_MAX_B}; pass x for more")
        tok = token.to(torch.int32).contiguous()
    else:
        B = x.shape[0]
        if x.device not in row:
            _check(x, "x", torch.float32, prep.device, (B, E))
    be, bl = (L, B, E), (L, B, El)
    for j, st in enumerate(states):
        dev = prep.shard_device(j)
        for name, t in zip(WKVState._fields, st):
            if j == 0 or prep.cards or name in ("aa", "bb", "pp"):
                _io(t, f"shard {j} state.{name}", dev, be if name in ("xy", "dd") else bl)
    n_stamps = 6 * L + 3 if prep.cards else 4 * L + 2
    stamps_ = [None] * len(prep.devices)
    if stamps is not None:
        stamps_ = list(stamps) if prep.cards else [stamps]
        if len(stamps_) != len(prep.devices):
            raise ValueError(f"decode_stack_tp: {len(prep.devices)} stamp tensors, one a card")
        for t, dev in zip(stamps_, prep.devices):
            _check(t, "stamps", torch.int64, dev, (t.numel(),))
            if t.numel() < n_stamps:
                raise ValueError(f"decode_stack_tp: stamps needs {n_stamps} entries")
    for j in range(n_here):
        decay, bonus = local[j]
        _io(decay, f"shard {j} decay", prep.shard_device(j), (L, El))
        _io(bonus, f"shard {j} bonus", prep.shard_device(j), (L, El))
    tables = prep.table(B)
    f32 = torch.float32
    k, n = len(_SHARED), len(_SHARD)
    # every input on its card and every output made before the first launch
    calls, logits, outs, xy_dd = [], [], [[] for _ in range(n_here)], []
    for c, ((arr, cap, _), dev) in enumerate(zip(tables, prep.devices)):
        shard_ids = [c] if prep.cards else list(range(n_here))
        xy_out = torch.empty(be, dtype=f32, device=dev)
        dd_out = torch.empty(be, dtype=f32, device=dev)
        lg = torch.empty((len(shard_ids), B, Vl), dtype=f32, device=dev)
        t_in = tok.to(dev) if token is not None else None
        x_in = x.to(dev).contiguous() if token is None else None
        if x_in is not None:
            _io(x_in, "x", dev, (B, E))
        st0 = states[shard_ids[0]]
        arr[_S["tokens"]] = t_in.data_ptr() if t_in is not None else None
        arr[_S["x_in"]] = x_in.data_ptr() if x_in is not None else None
        arr[_S["xy_in"]], arr[_S["dd_in"]] = st0.xy.data_ptr(), st0.dd.data_ptr()
        arr[_S["xy_out"]], arr[_S["dd_out"]] = xy_out.data_ptr(), dd_out.data_ptr()
        arr[_S["logits"]] = lg.data_ptr()
        arr[_S["stamps"]] = None if stamps_[c] is None else stamps_[c].data_ptr()
        for i, j in enumerate(shard_ids):
            decay, bonus = local[j]
            st = states[j]
            outs[j] = [torch.empty(bl, dtype=f32, device=dev) for _ in range(3)]
            base = k + i * n
            for name, t in zip(_SHARD_IO, (decay, bonus, st.aa, st.bb, st.pp, *outs[j])):
                arr[base + _D[name]] = t.data_ptr()
        calls.append((arr, cap, dev, (t_in, x_in)))
        logits.extend(lg.unbind(0))
        xy_dd.append((xy_out, dd_out))
    # each card's launch on that card's current stream, after only the copies
    # above: inside a capture across the cards (runtime/graphs.py) those are
    # streams forked from the capturing one before any work, so no card's
    # launch depends on another's; the launches spin on each other's flags,
    # and a replay that ordered them would wait until the trap
    lib = _kernel()
    for c, (arr, cap, dev, _) in enumerate(calls):
        launched, grid = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = lib.rwkv_decode_stack_tp(arr, len(arr), tp, prep.me(c),
                                           int(prep.cards), L, B, E, El, Fl, Vl, n_emb,
                                           int(prep.q4), prep.halves, cap, _COUNTERS,
                                           torch.cuda.current_stream(dev).cuda_stream,
                                           ctypes.byref(launched), ctypes.byref(grid))
        if prep.q4:
            launches_q4 += launched.value
        else:
            launches += launched.value
        _build.check(lib, err, f"decode_stack_tp on {dev}")
    if prep.cards:
        return logits, [WKVState(xy_dd[j][0], *outs[j], xy_dd[j][1]) for j in range(n_here)]
    xy_out, dd_out = xy_dd[0]
    return logits, [WKVState(xy_out, *outs[j], dd_out) for j in range(n_here)]
