"""RWKV-v4 in plain PyTorch (counterpart of rwkv_tpu/models/rwkv4.py).

This module is the port's oracle: `forward_step` and `forward_seq` are the
plain versions that the hand-written decode kernels (ops/cuda/) are held
against, on the CPU in the tests and on the card in chip_smoke.py.

Params are dataclasses of tensors with the JAX package's field names and a
stacked leading layer dim on every per-layer tensor. State is five tensors
[L, ..., E] (xy, aa, bb, pp, dd), the reference's RWKVState quintet.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.ops.layernorm import layer_norm
from rwkv_tpu_torch.ops.quant import (
    Quant4Linear,
    QuantLinear,
    dot_f32,
    q4matmul,
    qmatmul,
    quantize,
    quantize4,
    to_signed,
)
from rwkv_tpu_torch.ops.wkv import (
    WKVChannelState,
    wkv_parallel,
    wkv_scan,
    wkv_step,
)

Linear = QuantLinear | Quant4Linear | torch.Tensor  # dense: plain [in, out]


def _matmul(x: torch.Tensor, w: Linear, compute_dtype=torch.float32) -> torch.Tensor:
    """x @ w for any weight family. compute_dtype: the products' operand
    type (bf16 prefill: both operands rounded to bf16, the sums in float32,
    as the JAX package's _matmul)."""
    if isinstance(w, Quant4Linear):
        return q4matmul(x, w, compute_dtype)
    if isinstance(w, QuantLinear):
        return qmatmul(x, w, compute_dtype)
    if compute_dtype != x.dtype:
        return dot_f32(x.to(compute_dtype), w.to(compute_dtype))
    return x @ w


@dataclasses.dataclass
class LNParams:
    weight: torch.Tensor  # [..., E]
    bias: torch.Tensor    # [..., E]


@dataclasses.dataclass
class AttParams:
    """Time-mix half of a block. Leading dim: L."""

    mix_k: torch.Tensor      # [L, E]
    mix_v: torch.Tensor      # [L, E]
    mix_r: torch.Tensor      # [L, E]
    key: Linear              # [L, E, E]
    value: Linear            # [L, E, E]
    receptance: Linear       # [L, E, E]
    output: Linear           # [L, E, E]
    decay: torch.Tensor      # [L, E] — already -exp(time_decay)
    bonus: torch.Tensor      # [L, E] — time_first


@dataclasses.dataclass
class FFNParams:
    """Channel-mix half of a block. Leading dim: L."""

    mix_k: torch.Tensor      # [L, E]
    mix_r: torch.Tensor      # [L, E]
    key: Linear              # [L, E, 4E]
    value: Linear            # [L, 4E, E]
    receptance: Linear       # [L, E, E]


@dataclasses.dataclass
class RWKVParams:
    emb: torch.Tensor        # [V, E] float32
    ln0: LNParams            # [E]
    ln1: LNParams            # [L, E]
    ln2: LNParams            # [L, E]
    att: AttParams
    ffn: FFNParams
    ln_out: LNParams         # [E]
    head: Linear             # [E, V]
    # [V_padded]: 0 for real tokens, -1e9 for vocab padding (pad_vocab);
    # None for an unpadded model
    logit_bias: Optional[torch.Tensor] = None

    @property
    def n_layer(self) -> int:
        return self.att.decay.shape[0]

    @property
    def n_embd(self) -> int:
        return self.emb.shape[1]

    @property
    def vocab_size(self) -> int:
        return self.emb.shape[0]

    @property
    def config(self) -> RWKVConfig:
        return RWKVConfig(n_layer=self.n_layer, n_embd=self.n_embd,
                          vocab_size=self.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.emb.device


class WKVState(NamedTuple):
    """Recurrent state: 5 tensors [L, ..., E] (the '...' are stream dims)."""

    xy: torch.Tensor  # att token-shift memory
    aa: torch.Tensor
    bb: torch.Tensor
    pp: torch.Tensor
    dd: torch.Tensor  # ffn token-shift memory


def map_params(params: RWKVParams, fn: Callable) -> RWKVParams:
    """Apply fn to every array leaf (None and a Quant4Linear's int block
    stay as they are)."""

    def conv(obj):
        if obj is None or isinstance(obj, int):
            return obj
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{
                f.name: conv(getattr(obj, f.name))
                for f in dataclasses.fields(obj)})
        return fn(obj)

    return conv(params)


def params_to(params: RWKVParams, device) -> RWKVParams:
    """Move every leaf to `device` (numpy leaves are converted first)."""

    def move(a):
        if isinstance(a, np.ndarray):
            # a read-only array is a view of a mapped file: copy it out
            a = torch.from_numpy(np.array(a) if not a.flags.writeable
                                 else np.ascontiguousarray(a))
        return a.to(device)

    return map_params(params, move)


def init_state(config: RWKVConfig, batch_shape: Tuple[int, ...] = (),
               device=None) -> WKVState:
    """Empty state: zeros except pp = -1e30."""
    shape = (config.n_layer,) + tuple(batch_shape) + (config.n_embd,)
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return WKVState(xy=z(), aa=z(), bb=z(),
                    pp=torch.full(shape, -1e30, dtype=torch.float32, device=device),
                    dd=z())


def _layer(params: RWKVParams, i: int):
    """(ln1, ln2, att, ffn) of layer i (views, no copies)."""
    pick = lambda a: a[i]  # noqa: E731
    return (map_params(params.ln1, pick), map_params(params.ln2, pick),
            map_params(params.att, pick), map_params(params.ffn, pick))


def _ragged(length) -> bool:
    return torch.is_tensor(length) and length.dim() > 0


def _last_valid(xx: torch.Tensor, length) -> torch.Tensor:
    """xx at the last valid position (the carried token-shift state). length:
    a scalar, or [B] per-stream lengths with xx [T, B, E] (ragged batched
    prefill; a zero-length lane reads position 0, which _carry_valid drops)."""
    if length is None:
        return xx[-1]
    if _ragged(length):
        idx = (length.to(xx.device) - 1).clamp(min=0).long()
        return xx[idx, torch.arange(xx.shape[1], device=xx.device)]
    return xx[int(length) - 1]


def _carry_valid(new: torch.Tensor, old: torch.Tensor, length) -> torch.Tensor:
    """Ragged prefill: a stream with no valid token in this chunk keeps its
    previous token-shift state."""
    if not _ragged(length):
        return new
    return torch.where((length.to(new.device) > 0)[:, None], new, old)


def _att_seq(x, att: AttParams, ln: LNParams, xy, chan, *, parallel, mask,
             length, compute_dtype=torch.float32):
    xx = layer_norm(x, ln.weight, ln.bias)
    prev = torch.cat([xy[None], xx[:-1]], dim=0)  # token shift
    mm = partial(_matmul, compute_dtype=compute_dtype)
    k = mm(att.mix_k * xx + (1 - att.mix_k) * prev, att.key)
    v = mm(att.mix_v * xx + (1 - att.mix_v) * prev, att.value)
    r = mm(att.mix_r * xx + (1 - att.mix_r) * prev, att.receptance)
    wkv_fn = wkv_parallel if parallel else wkv_scan
    y, chan = wkv_fn(k, v, chan, att.decay, att.bonus, mask)
    out = mm(torch.sigmoid(r) * y, att.output)
    return x + out, _carry_valid(_last_valid(xx, length), xy, length), chan


def _ffn_seq(x, ffn: FFNParams, ln: LNParams, dd, *, length, compute_dtype=torch.float32):
    xx = layer_norm(x, ln.weight, ln.bias)
    prev = torch.cat([dd[None], xx[:-1]], dim=0)
    k_in = ffn.mix_k * xx + (1 - ffn.mix_k) * prev
    r_in = ffn.mix_r * xx + (1 - ffn.mix_r) * prev
    mm = partial(_matmul, compute_dtype=compute_dtype)
    gate = torch.sigmoid(mm(r_in, ffn.receptance))
    kk = torch.square(torch.relu(mm(k_in, ffn.key)))
    return x + gate * mm(kk, ffn.value), _carry_valid(_last_valid(xx, length), dd, length)


def _att_step(x, att: AttParams, ln: LNParams, xy, chan, mm=_matmul, mm_rows=_matmul):
    """One token through the attention half. mm: the product of the
    column-sliced families (k, v, r), mm_rows: att.output's; the plain W8A8
    step (ops/cuda/decode_stack.py) passes its own."""
    xx = layer_norm(x, ln.weight, ln.bias)
    k = mm(att.mix_k * xx + (1 - att.mix_k) * xy, att.key)
    v = mm(att.mix_v * xx + (1 - att.mix_v) * xy, att.value)
    r = mm(att.mix_r * xx + (1 - att.mix_r) * xy, att.receptance)
    y, chan = wkv_step(k, v, chan, att.decay, att.bonus)
    return x + mm_rows(torch.sigmoid(r) * y, att.output), xx, chan


def _ffn_step(x, ffn: FFNParams, ln: LNParams, dd, mm=_matmul, mm_rows=_matmul):
    """One token through the FFN half; mm, mm_rows as in _att_step (mm_rows:
    ffn.value's product)."""
    xx = layer_norm(x, ln.weight, ln.bias)
    k_in = ffn.mix_k * xx + (1 - ffn.mix_k) * dd
    r_in = ffn.mix_r * xx + (1 - ffn.mix_r) * dd
    gate = torch.sigmoid(mm(r_in, ffn.receptance))
    kk = torch.square(torch.relu(mm(k_in, ffn.key)))
    return x + gate * mm_rows(kk, ffn.value), xx


def _head(params: RWKVParams, x, compute_dtype=torch.float32):
    x = layer_norm(x, params.ln_out.weight, params.ln_out.bias)
    logits = _matmul(x, params.head, compute_dtype)
    if params.logit_bias is not None:
        logits = logits + params.logit_bias
    return logits


def forward_seq(params: RWKVParams, tokens: torch.Tensor, state: WKVState, *,
                parallel: bool = False, return_all_logits: bool = False,
                length: int | None = None,
                compute_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, WKVState]:
    """Run a token sequence (GPT mode). tokens: [T] or [T, B].

    length: optional count of valid leading tokens; later positions are
    padding whose state updates are no-ops (bucketed prefill). A scalar, or
    with tokens [T, B] and parallel=True a [B] tensor of per-stream lengths
    (ragged batched prefill: a zero-length stream keeps its state).
    compute_dtype: the operand type of every product, the head's included
    (torch.bfloat16: bf16 prefill, the sums in float32, as the JAX package's
    compute_dtype); WKV, LayerNorm and the masks stay in float32.
    Returns (logits for the last valid position, or [T, ..., V] with
    return_all_logits; new state). The input state is not modified."""
    x = layer_norm(params.emb[tokens].float(), params.ln0.weight, params.ln0.bias)
    T = x.shape[0]
    mask = None
    if length is not None:
        if _ragged(length):
            if not parallel:
                raise ValueError("per-stream lengths need parallel=True")
            if length.dim() != 1 or x.dim() != 3 or length.shape[0] != x.shape[1]:
                raise ValueError(f"length {tuple(length.shape)} does not fit tokens "
                                 f"{tuple(tokens.shape)}")
            length = length.to(x.device)
            mask = torch.arange(T, device=x.device)[:, None] < length[None, :]
        else:
            mask = torch.arange(T, device=x.device) < int(length)

    new = {f: [] for f in WKVState._fields}
    for i in range(params.n_layer):
        ln1, ln2, att, ffn = _layer(params, i)
        x, xy, chan = _att_seq(
            x, att, ln1, state.xy[i],
            WKVChannelState(state.aa[i], state.bb[i], state.pp[i]),
            parallel=parallel, mask=mask, length=length, compute_dtype=compute_dtype)
        x, dd = _ffn_seq(x, ffn, ln2, state.dd[i], length=length, compute_dtype=compute_dtype)
        for f, val in zip(WKVState._fields, (xy, chan.aa, chan.bb, chan.pp, dd)):
            new[f].append(val)
    new_state = WKVState(*(torch.stack(new[f]) for f in WKVState._fields))
    logits = _head(params, x if return_all_logits else _last_valid(x, length), compute_dtype)
    return logits, new_state


def forward_step(params: RWKVParams, token: torch.Tensor, state: WKVState
                 ) -> Tuple[torch.Tensor, WKVState]:
    """One decode step. token: scalar (state [L, E]) or [B] (state [L, B, E]).
    Returns (logits [..., V], new state); the input state is not modified.
    The embedding rows are gathered by index_select: indexing with a 0-d
    CUDA tensor reads it on the host, which a CUDA graph's capture refuses."""
    emb = params.emb.index_select(0, token.reshape(-1)).reshape(*token.shape, -1)
    x = layer_norm(emb.float(), params.ln0.weight, params.ln0.bias)
    new = {f: [] for f in WKVState._fields}
    for i in range(params.n_layer):
        ln1, ln2, att, ffn = _layer(params, i)
        x, xy, chan = _att_step(
            x, att, ln1, state.xy[i],
            WKVChannelState(state.aa[i], state.bb[i], state.pp[i]))
        x, dd = _ffn_step(x, ffn, ln2, state.dd[i])
        for f, val in zip(WKVState._fields, (xy, chan.aa, chan.bb, chan.pp, dd)):
            new[f].append(val)
    return _head(params, x), WKVState(*(torch.stack(new[f]) for f in WKVState._fields))


_FAMILIES = (("att", ("key", "value", "receptance", "output")),
             ("ffn", ("key", "value", "receptance")))


def _map_families(params: RWKVParams, fn: Callable) -> RWKVParams:
    """Apply fn(linear, row_tiled) to the 7 matrix families and the head.
    row_tiled is True for att.output and ffn.value, whose input comes out of
    a column-parallel epilogue (the families a q4 block pairs within)."""
    parts = {}
    for half, names in _FAMILIES:
        group = getattr(params, half)
        parts[half] = dataclasses.replace(group, **{
            n: fn(getattr(group, n), (half, n) in (("att", "output"), ("ffn", "value")))
            for n in names})
    return dataclasses.replace(params, head=fn(params.head, False), **parts)


def signedize_params(params: RWKVParams) -> RWKVParams:
    """Re-center every QuantLinear to int8 (ops.quant.to_signed), as the
    kernels need. Numerically identical: (W-128)*r + (o+128r) == W*r + o.
    Quant4Linear families are signed-centered already and pass through."""
    return _map_families(
        params, lambda lin, _: to_signed(lin) if isinstance(lin, QuantLinear) else lin)


def pad_vocab(params: RWKVParams, multiple: int = 128) -> RWKVParams:
    """Pad emb rows / head columns up to `multiple`; padded logits get a
    -1e9 `logit_bias` so they are never sampled. A Quant4Linear head is
    padded with zero bytes, which decode to the code -8 on both nibbles;
    the bias masks those columns all the same."""
    V = params.emb.shape[0]
    Vp = ((V + multiple - 1) // multiple) * multiple
    if Vp == V and params.logit_bias is not None:
        return params
    pad = Vp - V
    emb = torch.nn.functional.pad(params.emb, (0, 0, 0, pad))
    head = params.head
    if isinstance(head, Quant4Linear):
        head = dataclasses.replace(head, wp=torch.nn.functional.pad(head.wp, (0, pad)))
    elif isinstance(head, QuantLinear):
        head = QuantLinear(w=torch.nn.functional.pad(head.w, (0, pad)),
                           scale=head.scale, offset=head.offset)
    else:
        head = torch.nn.functional.pad(head, (0, pad))
    dev = params.emb.device
    if params.logit_bias is not None:
        # re-padding a padded model: keep the old pad ids banned
        bias = torch.cat([params.logit_bias,
                          torch.full((pad,), -1e9, dtype=torch.float32, device=dev)])
    else:
        bias = torch.where(torch.arange(Vp, device=dev) < V,
                           torch.tensor(0.0, device=dev),
                           torch.tensor(-1e9, device=dev))
    return dataclasses.replace(params, emb=emb, head=head, logit_bias=bias)


def q4_pack_block(n_embd: int, tp: int = 1) -> int:
    """The q4 format's default pairing block for the row-tiled families
    (att.output, ffn.value): n_embd where 12 * n_embd^2 <= 15 MiB, else the
    widest of 512, 384, 256, 128 that divides n_embd and fits that budget
    (1024 at 430M, 256 at 7B). The same arithmetic as the JAX package's
    pick_tile_q4, kept so that artifacts packed by either package carry the
    same blocks; the port's kernels take any even block that divides K.

    tp > 1: the widest of those candidates that also divides a shard's rows,
    n_embd / tp and 4 * n_embd / tp, so that no block straddles two shards
    of a tensor-parallel mesh (430M: 512 at tp = 2, 256 at tp = 4; 14B at
    tp = 8: 128). The JAX engine picks this block with its TP kernel's VMEM
    tile model (pick_tp_fused_tile), which the port does not have."""
    el, fl = n_embd // tp, 4 * n_embd // tp
    for t in (n_embd, 512, 512, 384, 256, 128):
        if (el % t == 0 and fl % t == 0 and t % 128 == 0 and (t == n_embd or t <= 512)
                and 12 * n_embd * t <= 15 * 1024 * 1024):
            return t
    if n_embd % tp == 0 and el % 128 == 0:
        return 128
    raise ValueError(f"n_embd {n_embd} / tp {tp} not divisible by any 128-multiple block")


def a8_block_for(n_embd: int) -> int:
    """The W8A8 activation-quantization block of the row-tiled families
    (att.output, ffn.value) that the JAX engine's fused a8 step uses: its
    decode tile, pick_tile(E) = E where 16 * E^2 <= 15 MiB, else the widest of
    512, 384, 256, 128 that divides E and fits that budget (512 at 430M, 768
    at E = 768, 256 at E = 2048 and 2560). Each block of that many input
    channels gets its own int8 scale, so the block changes the numbers: it is
    a numerical parameter of a8 decode, kept so that the port's a8 step gives
    the JAX engine's results, not a tile model of the card."""
    for t in (n_embd, 512, 512, 384, 256, 128):
        if (n_embd % t == 0 and t % 128 == 0 and (t == n_embd or t <= 512)
                and 16 * n_embd * t <= 15 * 1024 * 1024):
            return t
    if n_embd % 128 == 0:
        return 128
    raise ValueError(f"n_embd {n_embd} not divisible by any 128-multiple block")


def quantize_params(params: RWKVParams) -> RWKVParams:
    """Quantize the 8 dense matrix families to u8 QuantLinear with numpy
    leaves (emb, norms and mixes stay dense), as the reference converter
    splits them."""
    return _map_families(
        params, lambda w, _: w if isinstance(w, QuantLinear) else quantize(w))


def quantize_params_q4(params: RWKVParams, tile: int | None = None) -> RWKVParams:
    """Quantize the 8 dense matrix families to Quant4Linear with numpy
    leaves. The row-tiled families (att.output, ffn.value) pair rows within
    blocks of `tile` (default q4_pack_block(E)); the others pair globally."""
    if tile is None:
        tile = q4_pack_block(params.n_embd)

    def q(w, row_tiled):
        block = tile if row_tiled else None
        if isinstance(w, Quant4Linear):
            if w.block != block:
                raise ValueError(f"family packed with block={w.block}, expected {block}")
            return w
        if isinstance(w, QuantLinear):
            raise TypeError("cannot requantize u8 params to 4-bit; start from dense weights")
        return quantize4(w, block=block)

    return _map_families(params, q)


def init_params(config: RWKVConfig, generator: torch.Generator,
                dtype=torch.float32) -> RWKVParams:
    """Random dense params (tests, benches, a stand-in checkpoint): the JAX
    init_params' shapes, scales and ranges (weights N(0, 1/sqrt(in)), emb
    N(0, 0.1), mixes U(0.1, 0.9), decay -exp(N(0, 1)), bonus N(0, 0.5),
    unit layer norms), drawn from `generator` on its device in that order.
    The draws are not jax.random's: tests carry JAX params over with
    tests/_torch_port.py::to_port."""
    E, L, V, F = config.n_embd, config.n_layer, config.vocab_size, config.n_ffn
    dev = generator.device

    def mat(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev) * scale).to(dtype)

    def mix(shape):
        u = torch.rand(shape, generator=generator, device=dev)
        return (0.1 + 0.8 * u).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return RWKVParams(
        emb=mat((V, E), 0.1),
        ln0=LNParams(ones(E), zeros(E)),
        ln1=LNParams(ones(L, E), zeros(L, E)),
        ln2=LNParams(ones(L, E), zeros(L, E)),
        att=AttParams(
            mix_k=mix((L, E)), mix_v=mix((L, E)), mix_r=mix((L, E)),
            key=mat((L, E, E), E ** -0.5), value=mat((L, E, E), E ** -0.5),
            receptance=mat((L, E, E), E ** -0.5), output=mat((L, E, E), E ** -0.5),
            decay=-torch.exp(mat((L, E), 1.0)),
            bonus=mat((L, E), 0.5),
        ),
        ffn=FFNParams(
            mix_k=mix((L, E)), mix_r=mix((L, E)),
            key=mat((L, E, F), E ** -0.5), value=mat((L, F, E), F ** -0.5),
            receptance=mat((L, E, E), E ** -0.5),
        ),
        ln_out=LNParams(ones(E), zeros(E)),
        head=mat((E, V), E ** -0.5),
    )


def random_quantized_params_np(cfg: RWKVConfig, seed: int = 0,
                               pad_multiple: int | None = 512, *,
                               q4: bool = False, q4_block: int | None = None) -> RWKVParams:
    """Random quantized params built on the host in numpy (leaves are
    numpy arrays; `params_to` puts them on a device). The same recipe as
    the JAX package's random_quantized_params_np: u8 codes with scales
    sized like a quantized N(0, 1/sqrt(in)) matrix.

    q4: packed 4-bit Quant4Linear families instead (the counterpart of the
    JAX package's random_quantized_params_device(q4=True)): random bytes as
    the packed codes, 16-level scales, the +8 * scale centering in the
    offsets. The row-tiled families (att.output, ffn.value) carry the
    pairing block q4_block (default q4_pack_block(E); a tensor-parallel
    mesh needs one inside a shard, q4_pack_block(E, tp)); the others pair
    globally. The bytes are random, so any valid block tag gives valid
    params."""
    rng = np.random.default_rng(seed)
    E, L, V, F = cfg.n_embd, cfg.n_layer, cfg.vocab_size, cfg.n_ffn
    Vp = V
    if pad_multiple:
        Vp = ((V + pad_multiple - 1) // pad_multiple) * pad_multiple
    if q4 and q4_block is None:
        q4_block = q4_pack_block(E)

    def qrand(shape, row_tiled=False):
        span = 8.0 * shape[-2] ** -0.5  # ~±4 sigma
        if q4:
            r = span / 15.0
            return Quant4Linear(
                wp=rng.integers(-128, 128, size=shape[:-2] + (shape[-2] // 2, shape[-1]),
                                dtype=np.int8),
                scale=np.full(shape[:-1], r, np.float32),
                offset=np.full(shape[:-1], -span / 2.0 + 8.0 * r, np.float32),
                block=q4_block if row_tiled else None)
        return QuantLinear(
            w=rng.integers(0, 256, size=shape, dtype=np.uint8),
            scale=np.full(shape[:-1], span / 255.0, np.float32),
            offset=np.full(shape[:-1], -span / 2.0, np.float32))

    def f32(a):
        return np.asarray(a, np.float32)

    def mix(shape):
        return f32(rng.uniform(0.1, 0.9, size=shape))

    emb = np.zeros((Vp, E), np.float32)
    emb[:V] = rng.normal(0, 0.1, size=(V, E)).astype(np.float32)
    logit_bias = None
    if Vp != V:
        logit_bias = np.zeros((Vp,), np.float32)
        logit_bias[V:] = -1e9
    ones, zeros = (lambda *s: np.ones(s, np.float32)), (lambda *s: np.zeros(s, np.float32))
    return RWKVParams(
        emb=emb,
        ln0=LNParams(ones(E), zeros(E)),
        ln1=LNParams(ones(L, E), zeros(L, E)),
        ln2=LNParams(ones(L, E), zeros(L, E)),
        att=AttParams(
            mix_k=mix((L, E)), mix_v=mix((L, E)), mix_r=mix((L, E)),
            key=qrand((L, E, E)), value=qrand((L, E, E)),
            receptance=qrand((L, E, E)), output=qrand((L, E, E), row_tiled=True),
            decay=f32(-np.exp(rng.normal(size=(L, E)))),
            bonus=f32(rng.normal(size=(L, E)) * 0.5),
        ),
        ffn=FFNParams(
            mix_k=mix((L, E)), mix_r=mix((L, E)),
            key=qrand((L, E, F)), value=qrand((L, F, E), row_tiled=True),
            receptance=qrand((L, E, E)),
        ),
        ln_out=LNParams(ones(E), zeros(E)),
        head=qrand((E, Vp)),
        logit_bias=logit_bias,
    )
