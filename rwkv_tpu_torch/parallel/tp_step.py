"""Tensor-parallel decode step and prefill with the minimal collective
schedule (counterpart of rwkv_tpu/parallel/tp_step.py).

Every rank-1 quant-offset partial is folded into its matmul's partial (a sum
of partials is the partial of the sum), which gives exactly

    per block : 2 psums ([B, E] f32: att out-projection, ffn value)
                + 1 all-gather ([B, E] sigmoid gate, column-parallel)
    per token : + 1 psum (vocab-sharded embedding gather)
                + 1 all-gather (vocab-sharded logits)

3L + 2 collectives per step (and per prefill call), counted by the mesh
(parallel/mesh.py). At tp = 1 no collective is issued at all. The layouts
are parallel/sharding.py's.

The body runs every shard of the mesh in turn from one process, as JAX's
shard_map runs one program over all of them. Bodies, by their JAX names:

  "plain"  <-> "xla"     per-shard qmatmul and torch ops;
  "halves" <-> "pallas"  per shard and layer, kernel K6 (ops/cuda/tp_halves.py:
                         att_half, ffn_half) between the collectives, and the
                         vocab-shard head on kernel K2 (ops/cuda/mm8.py);
  "fused"  <-> "fused"   the whole step of every shard of a data row as one
                         call of kernel K7 (ops/cuda/decode_stack_tp.py), the
                         exchanges inside it: at B <= 8 per data row the
                         embedding gather rides in it too and the logits
                         gather is the mesh's only collective (0 psums and 1
                         gather a step at tp >= 2); at B > 8 the embedding
                         psum feeds it an x (1 and 1); none at tp = 1. q8 or
                         q4 weights.

4-bit params run only through "fused", as in JAX. body=None picks "fused"
where K7 is eligible (signed int8 or 4-bit weights, E / tp and each shard's
vocab multiples of 128) and every data row's shards lie on one CUDA device
or each on its own card with peer access between every pair (K7 across
cards: one launch per card, the exchanges peer stores over NVLink), the JAX
rule on an accelerator; else "halves" where the Pallas rule makes it
eligible (signed int8 weights, (E / tp) % 128 == 0), else "plain", as
make_tp_step does on a CPU backend. body="fused" over a row of cards without
peer access raises, naming the pair. On CPU tensors the kernel bodies run
their kernels' plain versions; on CUDA tensors the kernels. Over distinct
cards the collectives of "plain" and "halves", and the fused body's one
logits gather, are the mesh's NCCL collectives (parallel/mesh.py).

The step takes the state either whole ([L, B, E] leaves on the mesh's first
device: cut into per-shard pieces for the call and joined after,
sharding.shard_state / unshard_state) or resident per shard
(sharding.ShardedState, returned as one, with no cut and no join): the
engine and the pool keep theirs resident.

On a pod mesh (parallel/multihost.py: pod_mesh), whose data axis spans
processes, the step, the prefill and the engine adapters take and return this
process's streams only (multihost.local_batch cuts a global batch to them),
as the JAX pod is fed host-local arrays: B splits over the mesh's local data
rows. Where a row's model axis also spans processes (pod_mesh(model=tp),
tp wider than a process's devices), each process runs its own shards of the
row (mesh.local_shards from mesh.first_shard; the embedding gather and the
head take the global shard index), and the exchanges cross the process
boundary inside the step: the mesh's collectives over the row's process
group for "plain" and "halves" (NCCL between cards), and for "fused" kernel
K7's peer stores into the other processes' receive slots, opened through
CUDA IPC, plus the one logits gather. Every process of the row runs the
same step at the same call (SPMD, as the JAX program). "fused" there needs
one card a process, each on its own card of one host with peer access
(decode_stack_tp.process_row_problem: the auto choice takes "fused" only
where it passes, and K7's first call on a row that fails it raises, naming
why); a row whose processes share a card takes "halves" or "plain", whose
collectives need no peer memory.

The "halves" body on a mesh whose every shard names one CUDA device, every
body on a mesh whose data rows run over distinct cards of this process (one
capture across the cards: each card's K7 launch, or its K6 + K2 launches or
plain ops, and the NCCL collectives between the cards), and every body on a
row across processes of one card each whose group is NCCL
(runtime/graphs.py: graphable), replays a CUDA graph of the whole step, the
NCCL collectives and K7's launches inside it: eagerly, the host's work a
layer (wrapper checks, outputs, collectives) takes longer than the
device's, so the host would set the pace. One graph per (sharded params, B),
captured at that key's first call right after the call ran eagerly (the
warm-up); each replay advances the launch counters and the mesh's collective
counts by what the capture recorded. Inside a caller's own capture (the
engine's and the pool's decode programs) the step enqueues eagerly into it.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from rwkv_tpu_torch.models.rwkv4 import (
    WKVState,
    _carry_valid,
    _last_valid,
    _layer,
    _matmul,
)
from rwkv_tpu_torch.ops.cuda.decode_stack_tp import (
    FUSE_EMBED_MAX_B,
    decode_stack_tp,
    fused_problem,
    process_row_problem,
    row_devices,
)
from rwkv_tpu_torch.ops.cuda.mm8 import mm8
from rwkv_tpu_torch.ops.cuda.tp_halves import att_half, ffn_half
from rwkv_tpu_torch.ops.layernorm import layer_norm
from rwkv_tpu_torch.ops.quant import Quant4Linear, QuantLinear
from rwkv_tpu_torch.ops.wkv import WKVChannelState, wkv_parallel, wkv_step
from rwkv_tpu_torch.parallel.mesh import Mesh
from rwkv_tpu_torch.parallel.sharding import (
    ShardedParams,
    ShardedState,
    shard_state,
    unshard_state,
)
from rwkv_tpu_torch.runtime.graphs import Graphs, graphable

BODIES = ("plain", "halves", "fused")


def _grid(mesh: Mesh, fn: Callable):
    """[[fn(d, j) for each local model shard j] for each local data row d]."""
    return [[fn(d, j) for j in range(mesh.local_shards)] for d in range(mesh.local_rows)]


class _Collectives:
    """The model-axis collectives of one call; identities at tp = 1."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.on = mesh.shape["model"] > 1

    def psum(self, parts):
        return self.mesh.psum(parts) if self.on else parts

    def gather(self, parts, first_only: bool = False):
        """first_only: the caller reads only each row's shard 0 (the
        logits), so the gathered tensor is not copied out to the others."""
        if not self.on:
            return parts
        return self.mesh.all_gather(parts, dim=-1, first_only=first_only)


def _split_batch(mesh: Mesh, t: torch.Tensor, dim: int):
    """t split over this process's data rows along dim, placed on every
    shard's device."""
    rows = torch.chunk(t, mesh.local_rows, dim)
    return _grid(mesh, lambda d, j: rows[d].to(mesh.devices[d][j]))


def _join_batch(mesh: Mesh, grid, dim: int) -> torch.Tensor:
    """The inverse of _split_batch for a replicated result: shard 0's pieces
    joined on the first device."""
    rows = [row[0].to(mesh.first_device) for row in grid]
    return torch.cat(rows, dim=dim) if len(rows) > 1 else rows[0]


def _embed_psum(sp: ShardedParams, tokens, comm: _Collectives):
    """Vocab-sharded embedding gather (shard first_shard + j holds its
    global slice) -> one psum -> ln0. tokens[d][j]: [B] for a decode step or
    [T, B] for prefill. At tp = 1: a plain lookup."""
    mesh = sp.mesh

    def rows(d, j):
        p, t = sp.rows[d][j], tokens[d][j]
        Vl = p.emb.shape[0]
        if not comm.on:
            return p.emb[t.clamp(0, Vl - 1)]
        lo = (mesh.first_shard + j) * Vl
        mine = ((t >= lo) & (t < lo + Vl))[..., None]
        got = p.emb[(t - lo).clamp(0, Vl - 1)]
        return torch.where(mine, got, torch.zeros_like(got))

    x = comm.psum(_grid(mesh, rows))
    return _grid(mesh, lambda d, j: layer_norm(x[d][j].float(), sp.rows[d][j].ln0.weight,
                                               sp.rows[d][j].ln0.bias))


def _head(sp: ShardedParams, x, comm: _Collectives, kernel: bool):
    """ln_out, the shard's vocab columns of the head (+ its logit-bias
    slice), then the logits gather."""

    def local(d, j):
        p = sp.rows[d][j]
        h = layer_norm(x[d][j], p.ln_out.weight, p.ln_out.bias)
        if kernel:  # K2 on the shard's columns; the caller's offset term
            return mm8((h * p.head.scale).contiguous(), p.head.w, row_add=h @ p.head.offset,
                       col_add=p.logit_bias)
        logits = _matmul(h, p.head)
        return logits if p.logit_bias is None else logits + p.logit_bias

    return comm.gather(_grid(sp.mesh, local), first_only=True)


def _stack(layers) -> WKVState:
    return WKVState(*(torch.stack(v) for v in zip(*layers)))


def _tp_step_local(sp: ShardedParams, tokens, states, comm: _Collectives):
    """The plain body: per-shard qmatmul matvecs and torch ops."""
    mesh = sp.mesh
    x = _embed_psum(sp, tokens, comm)
    new = _grid(mesh, lambda d, j: [])
    for i in range(sp.n_layer):
        att_out = {}

        def att(d, j):
            ln1, _, a, _ = _layer(sp.rows[d][j], i)
            st = states[d][j]
            xx = layer_norm(x[d][j], ln1.weight, ln1.bias)
            ik = a.mix_k * xx + (1 - a.mix_k) * st.xy[i]
            iv = a.mix_v * xx + (1 - a.mix_v) * st.xy[i]
            ir = a.mix_r * xx + (1 - a.mix_r) * st.xy[i]
            k, v, r = _matmul(ik, a.key), _matmul(iv, a.value), _matmul(ir, a.receptance)
            w, u = (s[i] for s in sp.local(d, j))
            y, chan = wkv_step(k, v, WKVChannelState(st.aa[i], st.bb[i], st.pp[i]), w, u)
            att_out[d, j] = (xx, chan)
            return _matmul(torch.sigmoid(r) * y, a.output)  # row-parallel partial

        s = comm.psum(_grid(mesh, att))
        x = _grid(mesh, lambda d, j: x[d][j] + s[d][j])
        ffn_out = {}

        def ffn(d, j):
            _, ln2, _, f = _layer(sp.rows[d][j], i)
            dd = states[d][j].dd[i]
            xx2 = layer_norm(x[d][j], ln2.weight, ln2.bias)
            fk = f.mix_k * xx2 + (1 - f.mix_k) * dd
            fr = f.mix_r * xx2 + (1 - f.mix_r) * dd
            gate = torch.sigmoid(_matmul(fr, f.receptance))
            h = torch.square(torch.relu(_matmul(fk, f.key)))
            ffn_out[d, j] = (xx2, gate)
            return _matmul(h, f.value)

        vfull = comm.psum(_grid(mesh, ffn))
        gate = comm.gather(_grid(mesh, lambda d, j: ffn_out[d, j][1]))
        x = _grid(mesh, lambda d, j: x[d][j] + gate[d][j] * vfull[d][j])
        for (d, j), (xx, chan) in att_out.items():
            new[d][j].append((xx, chan.aa, chan.bb, chan.pp, ffn_out[d, j][0]))
    logits = _head(sp, x, comm, kernel=False)
    return logits, _grid(mesh, lambda d, j: _stack(new[d][j]))


def _tp_step_local_halves(sp: ShardedParams, tokens, states, comm: _Collectives):
    """The K6 body: per shard and layer, att_half and ffn_half between the
    collectives, then the vocab-shard head on K2."""
    mesh = sp.mesh
    x = _embed_psum(sp, tokens, comm)
    new = _grid(mesh, lambda d, j: [])
    for i in range(sp.n_layer):
        att_out = {}

        def att(d, j):
            st = states[d][j]
            partial, *rest = att_half(sp.rows[d][j], i, x[d][j], st.xy[i], st.aa[i], st.bb[i],
                                      st.pp[i], *sp.local(d, j))
            att_out[d, j] = rest  # aa, bb, pp, xx
            return partial

        s = comm.psum(_grid(mesh, att))
        x = _grid(mesh, lambda d, j: x[d][j] + s[d][j])
        ffn_out = {}

        def ffn(d, j):
            vpart, gate, xx2 = ffn_half(sp.rows[d][j], i, x[d][j], states[d][j].dd[i])
            ffn_out[d, j] = (gate, xx2)
            return vpart

        vfull = comm.psum(_grid(mesh, ffn))
        gate = comm.gather(_grid(mesh, lambda d, j: ffn_out[d, j][0]))
        x = _grid(mesh, lambda d, j: torch.addcmul(x[d][j], gate[d][j], vfull[d][j]))
        for (d, j), (aa, bb, pp, xx) in att_out.items():
            new[d][j].append((xx, aa, bb, pp, ffn_out[d, j][1]))
    logits = _head(sp, x, comm, kernel=True)
    return logits, _grid(mesh, lambda d, j: _stack(new[d][j]))


def _tp_step_local_fused(sp: ShardedParams, tokens, states, comm: _Collectives):
    """The K7 body: one decode_stack_tp call per data row, then each shard's
    logit-bias slice and the logits gather."""
    mesh = sp.mesh
    fuse = tokens[0][0].shape[0] <= FUSE_EMBED_MAX_B
    x = None if fuse else _embed_psum(sp, tokens, comm)
    logits, new = [], []
    for d in range(mesh.local_rows):
        lg, st = decode_stack_tp(sp.rows[d], states[d],
                                 [sp.local(d, j) for j in range(mesh.local_shards)],
                                 x=None if fuse else x[d][0],
                                 token=tokens[d][0] if fuse else None,
                                 mesh=mesh if mesh.spans_processes else None)
        bias = [p.logit_bias for p in sp.rows[d]]
        logits.append([g if b is None else g + b for g, b in zip(lg, bias)])
        new.append(st)
    return comm.gather(logits, first_only=True), new


def _meta(params):
    """(a shard or the whole params, the whole padded vocab, E) for the checks."""
    if isinstance(params, ShardedParams):
        return params.rows[0][0], params.vocab_size, params.n_embd
    return params, params.emb.shape[0], params.emb.shape[1]


def _k7_rows(mesh: Mesh) -> bool:
    """Whether kernel K7 can run every data row: on one CUDA device (a
    virtual mesh), or each shard on its own card with peer access between
    every pair (decode_stack_tp.row_devices accepts it), or, for a row
    across processes, one card a process with peer access between every
    pair (process_row_problem; the same answer in every process, from the
    cards pod_mesh gathered)."""
    if mesh.spans_processes:
        return process_row_problem(mesh) is None
    try:
        for row in mesh.devices:
            row_devices(row)
    except (ValueError, RuntimeError):
        return False
    return True


def make_tp_step(mesh: Mesh, params, *, body: Optional[str] = None):
    """A (params, token [B], state) -> (logits [B, Vp], state) decode step
    over `mesh` with its body's collectives per token (3L + 2 for "plain"
    and "halves", at most 2 for "fused": the module docstring); params is the
    ShardedParams the step will be given (or the whole params, for the
    checks); state leaves [L, B, E], B divisible by this process's data rows
    (on a pod mesh the process's own streams), or a ShardedState of B
    streams, returned resident; the logits lie on the mesh's first device.

    body: "plain", "halves" (kernel K6; signed int8 weights and E / tp a
    multiple of 128), "fused" (kernel K7; signed int8 or 4-bit weights, E /
    tp and each shard's vocab multiples of 128, every data row on one CUDA
    device or each shard on its own card with peer access; the only body of
    4-bit params) or None (auto: "fused" where eligible, else "halves"
    where eligible, else "plain")."""
    tp = mesh.shape["model"]
    p0, V, E = _meta(params)
    q4 = isinstance(p0.att.key, Quant4Linear)
    if not q4 and (not isinstance(p0.head, QuantLinear)
                   or not isinstance(p0.att.key, QuantLinear)):
        raise TypeError("tp_step requires quantized params (models.rwkv4.quantize_params)")
    sharded = isinstance(params, ShardedParams) and V != p0.emb.shape[0]
    head_o = p0.head.out_features * (tp if sharded else 1)  # a shard holds Vp / tp columns
    F = p0.ffn.key.out_features * (tp if isinstance(params, ShardedParams) else 1)
    if V % tp or head_o % tp:
        raise ValueError(f"tp_step needs the (padded) vocab divisible by model={tp}; apply "
                         f"models.rwkv4.pad_vocab first (got {V})")
    if body not in (None,) + BODIES:
        raise ValueError(f"unknown body {body!r} (want 'plain', 'halves' or 'fused')")
    if q4:
        if body in ("plain", "halves"):
            raise ValueError("4-bit params run only through body='fused' (the plain and "
                             "halves bodies stream q8); quantize with quantize_params for those")
        body = "fused"
    problem = fused_problem(p0, tp, E, F, V)
    if body is None and problem is None and _k7_rows(mesh):
        body = "fused"
    if body == "fused":
        if problem is not None:
            raise problem[0](f"body='fused': {problem[1]}")
        for row in mesh.devices:
            if len(set(row)) > 1 or row[0].type == "cuda":
                row_devices(row)  # raises for a row K7 cannot run, naming why
    eligible = (not q4 and p0.att.key.w.dtype == torch.int8 and E % tp == 0
                and (E // tp) % 128 == 0)
    if body is None:
        body = "halves" if eligible else "plain"
    if body == "halves" and not eligible:
        raise ValueError(
            f"body='halves' requires signed int8 weights (models.rwkv4.signedize_params) and "
            f"E/tp a multiple of 128 (got dtype={p0.att.key.w.dtype}, E={E}, tp={tp})")
    local = {"plain": _tp_step_local, "halves": _tp_step_local_halves,
             "fused": _tp_step_local_fused}[body]
    nd = mesh.local_rows

    def eager(sp: ShardedParams, token: torch.Tensor, state):
        if isinstance(state, ShardedState):  # resident: no cut, no join
            tok = torch.nn.functional.pad(token, (0, state.per * nd - state.B))
            logits, cells = local(sp, _split_batch(mesh, tok, 0), state.cells,
                                  _Collectives(mesh))
            return _join_batch(mesh, logits, 0)[:state.B], state.replace(cells)
        logits, states = local(sp, _split_batch(mesh, token, 0), shard_state(state, mesh),
                               _Collectives(mesh))
        return _join_batch(mesh, logits, 0), unshard_state(states, mesh)

    graphed = graphable(mesh) and (body == "halves" or mesh.spans_processes
                                   or mesh.spans_cards)
    graphs = Graphs(mesh=mesh) if graphed else None

    def step(sp: ShardedParams, token: torch.Tensor, state):
        if isinstance(state, ShardedState):
            if token.shape != (state.B,):
                raise ValueError(f"tp_step: token must be [{state.B}] for a state of "
                                 f"{state.B} streams, got {tuple(token.shape)}")
        elif token.dim() != 1 or token.shape[0] % nd:
            raise ValueError(f"tp_step: token must be [B] with B divisible by this process's "
                             f"data rows ({nd}), got {tuple(token.shape)}")
        if graphs is None:
            return eager(sp, token, state)
        # the graph holds sp (through the partial), so its id names it
        return graphs((id(sp), token.shape[0]), partial(eager, sp), token, state)

    step.body = body
    step.graphed = graphs is not None
    step.graphs = graphs  # its replays, or None
    step.eager = eager  # the body without the graph, for measuring the two apart
    return step


def _tp_seq_local(sp: ShardedParams, tokens, states, length, comm: _Collectives,
                  compute_dtype=torch.float32):
    """The prefill body: [T, B] tokens through the parallel WKV scan on every
    shard, with the decode step's layouts and collectives (2 psums + 1 gather
    per block, + the embedding psum and the logits gather, per call).
    length[d][j]: [B] valid tokens per stream, or None (every lane full).
    compute_dtype: the layers' product operands (bf16 prefill); the head
    stays in float32, as in the JAX body."""
    mesh = sp.mesh
    mm = partial(_matmul, compute_dtype=compute_dtype)
    x = _embed_psum(sp, tokens, comm)  # [T, B, E]
    T = x[0][0].shape[0]

    def mask(d, j):
        if length is None:
            return None
        ln = length[d][j]
        return torch.arange(T, device=ln.device)[:, None] < ln[None, :]

    masks = _grid(mesh, mask)
    lens = length if length is not None else _grid(mesh, lambda d, j: None)
    new = _grid(mesh, lambda d, j: [])
    for i in range(sp.n_layer):
        att_out = {}

        def att(d, j):
            ln1, _, a, _ = _layer(sp.rows[d][j], i)
            st, n = states[d][j], lens[d][j]
            xx = layer_norm(x[d][j], ln1.weight, ln1.bias)
            prev = torch.cat([st.xy[i][None], xx[:-1]], dim=0)
            k = mm(a.mix_k * xx + (1 - a.mix_k) * prev, a.key)
            v = mm(a.mix_v * xx + (1 - a.mix_v) * prev, a.value)
            r = mm(a.mix_r * xx + (1 - a.mix_r) * prev, a.receptance)
            w, u = (s[i] for s in sp.local(d, j))
            y, chan = wkv_parallel(k, v, WKVChannelState(st.aa[i], st.bb[i], st.pp[i]), w, u,
                                   masks[d][j])
            att_out[d, j] = (_carry_valid(_last_valid(xx, n), st.xy[i], n), chan)
            return mm(torch.sigmoid(r) * y, a.output)

        s = comm.psum(_grid(mesh, att))
        x = _grid(mesh, lambda d, j: x[d][j] + s[d][j])
        ffn_out = {}

        def ffn(d, j):
            _, ln2, _, f = _layer(sp.rows[d][j], i)
            dd, n = states[d][j].dd[i], lens[d][j]
            xx2 = layer_norm(x[d][j], ln2.weight, ln2.bias)
            prev = torch.cat([dd[None], xx2[:-1]], dim=0)
            fk = f.mix_k * xx2 + (1 - f.mix_k) * prev
            fr = f.mix_r * xx2 + (1 - f.mix_r) * prev
            gate = torch.sigmoid(mm(fr, f.receptance))
            h = torch.square(torch.relu(mm(fk, f.key)))
            ffn_out[d, j] = (_carry_valid(_last_valid(xx2, n), dd, n), gate)
            return mm(h, f.value)

        vfull = comm.psum(_grid(mesh, ffn))
        gate = comm.gather(_grid(mesh, lambda d, j: ffn_out[d, j][1]))
        x = _grid(mesh, lambda d, j: x[d][j] + gate[d][j] * vfull[d][j])
        for (d, j), (xy, chan) in att_out.items():
            new[d][j].append((xy, chan.aa, chan.bb, chan.pp, ffn_out[d, j][0]))
    last = _grid(mesh, lambda d, j: _last_valid(x[d][j], lens[d][j]))
    logits = _head(sp, last, comm, kernel=False)
    return logits, _grid(mesh, lambda d, j: _stack(new[d][j]))


def make_tp_prefill(mesh: Mesh, params, *, masked: bool = True,
                    compute_dtype: torch.dtype = torch.float32):
    """(params, tokens [T, B], state, length [B]) -> (logits [B, Vp], state):
    batched ragged prefill over `mesh` with the decode step's layouts and
    collective schedule. masked=False builds the full-chunk variant
    (params, tokens, state), every lane full, with no mask. compute_dtype:
    the layers' product operands (torch.bfloat16: bf16 prefill)."""
    tp = mesh.shape["model"]
    p0, V, _ = _meta(params)
    if not isinstance(p0.att.key, (QuantLinear, Quant4Linear)):
        raise TypeError("tp prefill requires quantized params")
    if V % tp:
        raise ValueError(f"padded vocab {V} not divisible by model={tp}")
    nd = mesh.local_rows

    def prefill(sp: ShardedParams, tokens, state, length=None):
        resident = isinstance(state, ShardedState)
        if resident:
            if tokens.dim() != 2 or tokens.shape[1] != state.B:
                raise ValueError(f"tp prefill: tokens must be [T, {state.B}] for a state of "
                                 f"{state.B} streams, got {tuple(tokens.shape)}")
            pad = state.per * nd - state.B
            tokens = torch.nn.functional.pad(tokens, (0, pad))
            if masked:
                length = torch.nn.functional.pad(
                    torch.as_tensor(length, device=tokens.device), (0, pad))
        elif tokens.dim() != 2 or tokens.shape[1] % nd:
            raise ValueError(f"tp prefill: tokens must be [T, B] with B divisible by this "
                             f"process's data rows ({nd}), got {tuple(tokens.shape)}")
        lens = None
        if masked:
            lens = _split_batch(mesh, torch.as_tensor(length, device=tokens.device), 0)
        cells = state.cells if resident else shard_state(state, mesh)
        logits, states = _tp_seq_local(sp, _split_batch(mesh, tokens, 1), cells, lens,
                                       _Collectives(mesh), compute_dtype)
        if resident:
            return _join_batch(mesh, logits, 0)[:state.B], state.replace(states)
        return _join_batch(mesh, logits, 0), unshard_state(states, mesh)

    if masked:
        return prefill
    return lambda sp, tokens, state: prefill(sp, tokens, state)


def _pad_streams(state: WKVState, B: int, Bp: int) -> WKVState:
    if Bp == B:
        return state
    return WKVState(*(torch.nn.functional.pad(s, (0, 0, 0, Bp - B)) for s in state))


def make_engine_prefill(mesh: Mesh, params, *, compute_dtype: torch.dtype = torch.float32):
    """A forward_seq-shaped adapter over make_tp_prefill for the engine and
    the pool: tokens [T] or [T, B]; state leaves [L, E] or [L, B, E], or a
    ShardedState of B streams (tokens [T] then stand for its one stream); a
    scalar or [B] length, or None for a full chunk (every real lane holds T
    tokens); B padded up to the data rows (the padded lanes' results are
    dropped)."""
    masked = make_tp_prefill(mesh, params, compute_dtype=compute_dtype)
    full = make_tp_prefill(mesh, params, masked=False, compute_dtype=compute_dtype)
    nd = mesh.local_rows

    def prefill(sp, tokens, state, length=None):
        unb = tokens.dim() == 1
        if isinstance(state, ShardedState):  # resident: its lanes already padded
            tokens = tokens[:, None] if unb else tokens
            if length is not None:
                length = torch.as_tensor(length, device=tokens.device).to(torch.int64)
                length = length.expand(tokens.shape[1]) if length.dim() == 0 else length
                logits, st = masked(sp, tokens, state, length)
            else:
                logits, st = full(sp, tokens, state)
            return (logits[0] if unb else logits), st
        if unb:
            tokens = tokens[:, None]
            state = WKVState(*(s[:, None] for s in state))
        B = tokens.shape[1]
        Bp = -(-B // nd) * nd
        if length is not None:
            length = torch.as_tensor(length, device=tokens.device).to(torch.int64)
            length = length.expand(B) if length.dim() == 0 else length
            length = torch.nn.functional.pad(length, (0, Bp - B))
        tokens = torch.nn.functional.pad(tokens, (0, Bp - B))
        state = _pad_streams(state, B, Bp)
        if length is None:
            logits, st = full(sp, tokens, state)
        else:
            logits, st = masked(sp, tokens, state, length)
        if Bp != B:
            logits = logits[:B]
            st = WKVState(*(s[:, :B] for s in st))
        if unb:
            return logits[0], WKVState(*(s[:, 0] for s in st))
        return logits, st

    return prefill


def make_engine_step(mesh: Mesh, params, **kw):
    """A make_tp_step with forward_step's shapes, for the engine and the
    pool: token scalar or [B], state leaves [L, E] or [L, B, E], or a
    ShardedState of B streams (a scalar token then stands for its one
    stream); B padded up to the data rows (the padded streams compute on
    zero state, or a resident state's padding lanes, and are dropped)."""
    step = make_tp_step(mesh, params, **kw)
    nd = mesh.local_rows

    def engine_step(sp, token, state):
        unb = token.dim() == 0
        if isinstance(state, ShardedState):  # resident: its lanes already padded
            logits, st = step(sp, token.reshape(-1), state)
            return (logits[0] if unb else logits), st
        if unb:
            token = token[None]
            state = WKVState(*(s[:, None] for s in state))
        B = token.shape[0]
        Bp = -(-B // nd) * nd
        logits, st = step(sp, torch.nn.functional.pad(token, (0, Bp - B)),
                          _pad_streams(state, B, Bp))
        if Bp != B:
            logits = logits[:B]
            st = WKVState(*(s[:, :B] for s in st))
        if unb:
            return logits[0], WKVState(*(s[:, 0] for s in st))
        return logits, st

    engine_step.body = step.body
    engine_step.graphed = step.graphed
    engine_step.graphs = step.graphs
    return engine_step
