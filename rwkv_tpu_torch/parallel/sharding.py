"""How RWKV-v4 params and state split over a mesh (counterpart of
rwkv_tpu/parallel/sharding.py).

The tensor-parallel layout (Megatron-style column -> row pairing):

  att half, per block:
    key/value/receptance [L, E, E]  column-parallel: split on the output dim,
        so k, v, r come out split on E; the WKV step is elementwise over
        channels, so it runs on the shard's channels with no communication,
        and aa/bb/pp split on E with it.
    output               [L, E, E]  row-parallel: split on the contracted
        dim; each shard's product is a partial, summed by one psum.
  ffn half:
    key [L, E, 4E] column-parallel; relu^2 is elementwise on the shard.
    value [L, 4E, E] row-parallel: the second psum of the block.
    receptance [L, E, E] column-parallel: the gate is all-gathered.
  head [E, V] column-parallel: logits split on V, then all-gathered.
  emb [V, E] split on V: each shard gathers its rows, then one psum.
  layer norms, mixes, decay/bonus, the token-shift states: replicated.

A scale/offset vector splits with the contracted dim of its matrix for the
row-parallel families (the rank-1 offset term then rides the same psum) and
is replicated for the column-parallel ones. Streams (the batch dim of tokens
and state) split over the mesh's data rows.

A layout is a tree shaped like the params whose leaves say which dim of the
leaf splits over the model shards (None: replicated). shard_params() cuts
every leaf once, into contiguous tensors on each shard's device: a column
slice of [L, E, O] is a strided view, and the kernels read contiguous rows.
make_put() does the same cut per tensor while a .bin is read, each piece
sent from the host straight to its device, for every data row.

The state of a batch of streams stays resident per shard between calls
(ShardedState): cells[d][j] is model shard j of data row d's WKVState on
its device, aa/bb/pp cut on E, xy/dd replicated (state_pspecs). The engine
and the pool keep one and step it in place; it is joined into whole
tensors (unshard_state) or cut from them (shard_state) only where a caller
reads or writes a whole state. `counts` counts those cuts and joins.

On a mesh whose rows span processes (multihost.pod_mesh(model=tp) with tp
wider than a process's devices) every cut takes the global shard index,
first_shard + j: a process holds only its own weight columns, vocab slice
and state channels, and make_put copies out and places only those pieces of
each tensor it reads, so a card holds one shard's weights, not the model's.

Not ported: the JAX package's 4-D pretiled layout (the port has none).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.rwkv4 import (
    AttParams,
    FFNParams,
    LNParams,
    RWKVParams,
    WKVState,
)
from rwkv_tpu_torch.ops.quant import Quant4Linear, QuantLinear
from rwkv_tpu_torch.parallel.mesh import Mesh


class MeshShards(tuple):
    """One leaf already cut over a mesh (make_put): element [d][j] lives on
    mesh.devices[d][j]."""


# whole-state cuts (shard_state) and joins (unshard_state) made so far
counts = {"shard_state": 0, "unshard_state": 0}


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        # a read-only array is a view of a mapped file: copy it out
        return torch.from_numpy(np.array(a) if not a.flags.writeable
                                else np.ascontiguousarray(a))
    return a


def _zip_map(fn, tree, spec):
    """fn(leaf, leaf's spec) over the array leaves of a params tree."""
    if tree is None or isinstance(tree, int):
        return tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _zip_map(fn, getattr(tree, f.name), getattr(spec, f.name))
            for f in dataclasses.fields(tree)})
    return fn(tree, spec)


def _vocab(params: RWKVParams, mesh: Optional[Mesh] = None) -> int:
    """The whole (padded) vocab; a MeshShards embedding holds this process's
    shards of it."""
    emb = params.emb
    if not isinstance(emb, MeshShards):
        return emb.shape[0]
    n = sum(p.shape[0] for p in emb[0])
    return n * mesh.shape["model"] // mesh.local_shards if mesh is not None else n


def param_pspecs(params: RWKVParams, n_model: Optional[int] = None) -> RWKVParams:
    """The layout: a tree shaped like `params` whose leaves are the dim that
    splits over the model shards, or None (replicated).

    n_model: the model shards, used to decide whether the vocab dim of
    emb/head/logit_bias splits evenly (pad_vocab first for real models; an
    unpadded odd vocab stays replicated)."""
    vocab_ok = n_model is None or _vocab(params) % n_model == 0

    def mk(lin, row_parallel):
        w = -2 if row_parallel else -1
        vec = -1 if row_parallel else None
        if isinstance(lin, Quant4Linear):  # packed [L, K/2, O]: whole pack blocks per shard
            return Quant4Linear(wp=w, scale=vec, offset=vec, block=lin.block)
        if isinstance(lin, QuantLinear):
            return QuantLinear(w=w, scale=vec, offset=vec)
        return w

    ln = LNParams(None, None)
    vocab = 0 if vocab_ok else None
    head_w = -1 if vocab_ok else None
    head = params.head
    if isinstance(head, Quant4Linear):
        head = Quant4Linear(wp=head_w, scale=None, offset=None, block=head.block)
    elif isinstance(head, QuantLinear):
        head = QuantLinear(w=head_w, scale=None, offset=None)
    else:
        head = head_w
    return RWKVParams(
        emb=vocab, ln0=ln, ln1=ln, ln2=ln,
        att=AttParams(mix_k=None, mix_v=None, mix_r=None,
                      key=mk(params.att.key, False), value=mk(params.att.value, False),
                      receptance=mk(params.att.receptance, False),
                      output=mk(params.att.output, True), decay=None, bonus=None),
        ffn=FFNParams(mix_k=None, mix_r=None, key=mk(params.ffn.key, False),
                      value=mk(params.ffn.value, True),
                      receptance=mk(params.ffn.receptance, False)),
        ln_out=ln, head=head,
        logit_bias=None if params.logit_bias is None else vocab,
    )


def _cut_mesh(t, dim: Optional[int], mesh: Mesh) -> MeshShards:
    """t cut into tp contiguous pieces along dim (dim None: t whole), piece
    first_shard + j on mesh.devices[d][j] for every data row d (only this
    process's pieces are copied out and placed); a device named twice gets
    one copy. A MeshShards is taken as it is."""
    if isinstance(t, MeshShards):
        return t
    tp = mesh.shape["model"]
    t = _as_tensor(t)
    if dim is None:
        pieces = [t] * tp
    else:
        if t.shape[dim] % tp:
            raise ValueError(f"dim {dim} of a {tuple(t.shape)} leaf does not split over "
                             f"{tp} shards")
        pieces = list(torch.chunk(t, tp, dim))
    placed: dict = {}

    def on(j, dev):
        piece = pieces[mesh.first_shard + j]
        key = (id(piece), dev)
        if key not in placed:
            placed[key] = piece.contiguous().to(dev)
        return placed[key]

    return MeshShards(tuple(on(j, dev) for j, dev in enumerate(row)) for row in mesh.devices)


class ShardedParams:
    """RWKVParams cut over a mesh: rows[d][j] is model shard first_shard + j
    of data row d, every leaf a contiguous tensor on mesh.devices[d][j]
    (data rows share a shard's tensors where they name the same device); a
    process holds only its own shards."""

    def __init__(self, rows, mesh: Mesh, vocab_size: int):
        self.rows = rows
        self.mesh = mesh
        self.vocab_size = vocab_size
        self._local: dict = {}
        self._bias = None

    @property
    def n_layer(self) -> int:
        return self.rows[0][0].n_layer

    @property
    def n_embd(self) -> int:
        return self.rows[0][0].n_embd

    @property
    def config(self) -> RWKVConfig:
        return RWKVConfig(n_layer=self.n_layer, n_embd=self.n_embd, vocab_size=self.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.mesh.first_device

    @property
    def logit_bias(self) -> Optional[torch.Tensor]:
        """The whole [Vp] logit bias on the first device, or None (on a row
        across processes its first read gathers the other processes' slices:
        a collective, which the engine makes at load in every process)."""
        if self._bias is None and self.rows[0][0].logit_bias is not None:
            parts = [p.logit_bias.to(self.device) for p in self.rows[0]]
            vocab_split = parts[0].shape[0] != self.vocab_size
            self._bias = torch.cat(parts) if vocab_split else parts[0]
            if vocab_split:
                self._bias = self.mesh.group_gather(self._bias, 0)
        return self._bias

    def local(self, d: int, j: int):
        """(decay, bonus) of shard (d, j): its channel slice [L, E / tp] of
        the replicated vectors, contiguous, cut once."""
        got = self._local.get((d, j))
        if got is None:
            p, tp = self.rows[d][j], self.mesh.shape["model"]
            El, g = p.n_embd // tp, self.mesh.first_shard + j
            got = tuple(v[:, g * El:(g + 1) * El].contiguous()
                        for v in (p.att.decay, p.att.bonus))
            self._local[(d, j)] = got
        return got


def _check_q4_blocks(params: RWKVParams, tp: int) -> None:
    """A 4-bit row-parallel family is cut on its packed rows: each shard must
    hold whole pairing blocks, or a block would straddle two shards."""
    for name, lin in (("att.output", params.att.output), ("ffn.value", params.ffn.value)):
        if not isinstance(lin, Quant4Linear) or isinstance(lin.wp, MeshShards):
            continue
        K = lin.in_features
        b = lin.block or K
        if (K // tp) % b:
            raise ValueError(
                f"4-bit {name} is packed in blocks of {b} rows, which do not divide its "
                f"{K // tp} rows per shard at model={tp}: a block would straddle two shards; "
                f"requantize with quantize_params_q4(tile=models.rwkv4.q4_pack_block(E, {tp}))")


def shard_params(params: RWKVParams, mesh: Mesh) -> ShardedParams:
    """Cut `params` (numpy or torch leaves, or MeshShards leaves from make_put)
    over `mesh` by param_pspecs. A 4-bit row-parallel family's pairing block
    must divide its rows per shard (ValueError otherwise)."""
    tp = mesh.shape["model"]
    _check_q4_blocks(params, tp)
    vocab = _vocab(params, mesh)
    specs = param_pspecs(params, n_model=tp)
    cut = _zip_map(lambda leaf, dim: _cut_mesh(leaf, dim, mesh), params, specs)
    rows = [[_zip_map(lambda grid, _: grid[d][j], cut, specs)
             for j in range(mesh.local_shards)] for d in range(mesh.local_rows)]
    return ShardedParams(rows, mesh, vocab)


def state_pspecs(n_model: int = 0) -> WKVState:
    """The layout of a state with [L, B, E] leaves: (dim split over the data
    rows, dim split over the model shards) per leaf. aa/bb/pp split on E over
    the model shards; the token-shift memories xy/dd are replicated; streams
    split over data. n_model=1 splits nothing over the model axis."""
    shift = (1, None)
    chan = shift if n_model == 1 else (1, -1)
    return WKVState(xy=shift, aa=chan, bb=chan, pp=chan, dd=shift)


def shard_state(state: WKVState, mesh: Mesh):
    """A full state ([L, B, E] leaves) cut into a [data][model] grid of
    WKVStates over this process's rows and shards, each leaf contiguous on
    its shard's device. B (this process's streams) must split evenly over
    its data rows."""
    counts["shard_state"] += 1
    nd, tp, first = mesh.local_rows, mesh.shape["model"], mesh.first_shard
    specs = state_pspecs(n_model=tp)
    cells = [[{} for _ in range(mesh.local_shards)] for _ in range(nd)]
    for name, t, (ddim, mdim) in zip(WKVState._fields, state, specs):
        if t.shape[ddim] % nd:
            raise ValueError(f"batch {t.shape[ddim]} does not split over data={nd}")
        rows = torch.chunk(t, nd, ddim)
        for d, row in enumerate(rows):
            cols = torch.chunk(row, tp, mdim) if mdim is not None else [row] * tp
            for j in range(mesh.local_shards):
                cells[d][j][name] = cols[first + j].contiguous().to(mesh.devices[d][j])
    return [[WKVState(**c) for c in row] for row in cells]


def unshard_state(grid, mesh: Mesh) -> WKVState:
    """The inverse of shard_state: full leaves on the mesh's first device
    (for a row across processes the other processes' channels gathered over
    the row's group: a collective, which every process of the row makes)."""
    counts["unshard_state"] += 1
    specs = state_pspecs(n_model=mesh.shape["model"])
    first = mesh.first_device
    out = []
    for i, (ddim, mdim) in enumerate(specs):
        rows = []
        for row in grid:
            if mdim is None:
                rows.append(row[0][i].to(first))
            else:
                rows.append(mesh.group_gather(
                    torch.cat([cell[i].to(first) for cell in row], dim=mdim), mdim))
        out.append(torch.cat(rows, dim=ddim) if len(rows) > 1 else rows[0])
    return WKVState(*out)


class ShardedState:
    """The state of B streams resident per shard (the module docstring).

    cells[d][j]: model shard j of data row d, on mesh.devices[d][j]: xy/dd
    [L, per, E], the same values on every shard of the row, aa/bb/pp [L,
    per, E / tp]. Row d holds lanes d * per .. (d + 1) * per - 1 of the
    batch, per = ceil(B / data rows); the lanes from B on are padding, which
    the steps compute on and never return. Iterating gives every leaf
    tensor (cells row-major, WKVState's field order), so code that carries
    a state in place (`s.copy_(n)` over two states' leaves) takes it as it
    takes a WKVState."""

    def __init__(self, cells, mesh: Mesh, B: int):
        self.cells = cells
        self.mesh = mesh
        self.B = B
        self.per = cells[0][0].xy.shape[1]

    @staticmethod
    def lanes_per_row(B: int, mesh: Mesh) -> int:
        return -(-B // mesh.local_rows)

    @classmethod
    def zeros(cls, config: RWKVConfig, B: int, mesh: Mesh) -> "ShardedState":
        """A fresh state of B streams: zeros, and pp -1e30 (init_state)."""
        tp, per = mesh.shape["model"], cls.lanes_per_row(B, mesh)
        L, E = config.n_layer, config.n_embd

        def cell(dev):
            z = lambda w: torch.zeros((L, per, w), dtype=torch.float32, device=dev)  # noqa: E731
            return WKVState(xy=z(E), aa=z(E // tp), bb=z(E // tp),
                            pp=torch.full((L, per, E // tp), -1e30, dtype=torch.float32,
                                          device=dev), dd=z(E))

        return cls([[cell(dev) for dev in row] for row in mesh.devices], mesh, B)

    @classmethod
    def cut(cls, state: WKVState, mesh: Mesh) -> "ShardedState":
        """A whole state ([L, B, E] leaves) cut over the mesh (shard_state),
        padded to whole rows."""
        B = state.xy.shape[1]
        pad = cls.lanes_per_row(B, mesh) * mesh.local_rows - B
        if pad:
            state = WKVState(*(torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in state))
        return cls(shard_state(state, mesh), mesh, B)

    def join(self) -> WKVState:
        """The whole state, [L, B, E] leaves on the mesh's first device
        (unshard_state)."""
        whole = unshard_state(self.cells, self.mesh)
        return whole if self.per * len(self.cells) == self.B else \
            WKVState(*(t[:, :self.B] for t in whole))

    def replace(self, cells) -> "ShardedState":
        return ShardedState(cells, self.mesh, self.B)

    def __iter__(self):
        return (t for row in self.cells for cell in row for t in cell)

    def with_leaves(self, leaves) -> "ShardedState":
        """The same layout over other leaf tensors, in __iter__'s order."""
        it = iter(leaves)
        return self.replace([[WKVState(*(next(it) for _ in WKVState._fields)) for _ in row]
                             for row in self.cells])

    def _copy_lane(self, g: int, src: "ShardedState", k: int) -> None:
        """Stream g of this state := stream k of src, shard by shard."""
        d, i = divmod(g, self.per)
        ds, ks = divmod(k, src.per)
        for dst, got in zip(self.cells[d], src.cells[ds]):
            for t, u in zip(dst, got):
                t[:, i].copy_(u[:, ks])

    def take(self, lanes) -> "ShardedState":
        """Streams `lanes` (in that order) as a ShardedState of len(lanes)
        streams: on one data row each shard's lanes picked on its device;
        over several rows lane by lane (a stream may change rows)."""
        lanes = list(lanes)
        if len(self.cells) == 1:
            cells = [[WKVState(*(t.index_select(1, torch.tensor(lanes, device=t.device))
                                 for t in cell)) for cell in self.cells[0]]]
            return ShardedState(cells, self.mesh, len(lanes))
        L, _, E = self.cells[0][0].xy.shape
        out = ShardedState.zeros(RWKVConfig(n_layer=L, n_embd=E, vocab_size=1), len(lanes),
                                 self.mesh)
        for k, g in enumerate(lanes):
            out._copy_lane(k, self, g)
        return out

    def put(self, lanes, src: "ShardedState") -> None:
        """Write src's streams 0 .. len(lanes) - 1 into streams `lanes`, in
        place, each shard's on its device."""
        lanes = list(lanes)
        if src.B != len(lanes):
            raise ValueError(f"put: {src.B} streams for {len(lanes)} lanes")
        if len(self.cells) == 1 and len(src.cells) == 1:
            for dst, got in zip(self.cells[0], src.cells[0]):
                idx = torch.tensor(lanes, device=dst.xy.device)
                for t, u in zip(dst, got):
                    t.index_copy_(1, idx, u[:, :len(lanes)])
            return
        for k, g in enumerate(lanes):
            self._copy_lane(g, src, k)

    def where(self, active: torch.Tensor, old: "ShardedState") -> "ShardedState":
        """Per stream, this state where active[b] (a [B] bool), else old's."""
        act = torch.nn.functional.pad(active, (0, self.per * len(self.cells) - self.B))
        rows = act.reshape(len(self.cells), self.per)
        cells = []
        for d, (new_row, old_row) in enumerate(zip(self.cells, old.cells)):
            row = []
            for j, (n, o) in enumerate(zip(new_row, old_row)):
                a = rows[d].to(n.xy.device)[None, :, None]
                row.append(WKVState(*(torch.where(a, x, y) for x, y in zip(n, o))))
            cells.append(row)
        return self.replace(cells)


@dataclasses.dataclass
class ShardingContext:
    """Carried by the engine: the mesh."""

    mesh: Mesh


# .bin tensor name (io/registry.py) -> the dim split over the model shards
_PUT_DIMS = {
    "embed": 0, "km": -1, "vm": -1, "rm": -1,
    "att_out": -2, "att_out_r": -1, "att_out_o": -1,
    "ffn_k": -1, "ffn_r": -1, "ffn_v": -2, "ffn_vr": -1, "ffn_vo": -1,
    "head": -1, "logit_bias": 0,
}
_VOCAB_DIM = {"embed": 0, "head": 1, "logit_bias": 0}


def make_put(ctx: "ShardingContext | Mesh"):
    """A put(name, host_array) for io.binfmt.read_bin that cuts each tensor
    straight into its pieces on every data row's devices (MeshShards; a
    replicated tensor whole on each of them), each piece sent from the host
    to its own device, so the host holds about one tensor at a time and each
    device only its pieces. shard_params then takes the result as it is."""
    mesh = ctx.mesh if isinstance(ctx, ShardingContext) else ctx
    tp = mesh.shape["model"]

    def put(name: str, arr: np.ndarray):
        dim = _PUT_DIMS.get(name)
        vd = _VOCAB_DIM.get(name)
        if dim is None or (vd is not None and arr.shape[vd] % tp):
            dim = None
        return _cut_mesh(arr, dim, mesh)

    return put


def tp_vocab_multiple(tp: int) -> int:
    """The padded vocab a tp-wide mesh needs: each shard's Vp / tp a multiple
    of 128, and Vp a multiple of 512 (the engine's unsharded padding)."""
    return math.lcm(512, 128 * tp)
