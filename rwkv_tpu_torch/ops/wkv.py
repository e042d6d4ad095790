"""The WKV recurrence in the max-shift form (counterpart of rwkv_tpu/ops/wkv.py).

Per channel, with decay w = -exp(time_decay) < 0 and bonus u = time_first,
the state (aa, bb, pp) stands for A = aa * e^pp, B = bb * e^pp:

  output for token t (state before token t):
      q   = max(pp, u + k_t)
      y_t = (e^{pp-q} aa + e^{u+k_t-q} v_t) / (e^{pp-q} bb + e^{u+k_t-q})
  update:
      p'  = max(pp + w, k_t)
      aa' = e^{pp+w-p'} aa + e^{k_t-p'} v_t
      bb' = e^{pp+w-p'} bb + e^{k_t-p'}
      pp' = p'

Every exponent argument is <= 0, so float32 never overflows. The
reference CUDA kernel's shortcut without the max shift overflows on long
sequences and is not used. Empty state: aa = bb = 0, pp = -1e30.

`wkv_parallel` is the prefill form: a log-depth (Hillis-Steele) scan over T
of the per-token affine state maps, with the same `combine` as the JAX
package's associative scan.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class WKVChannelState(NamedTuple):
    aa: torch.Tensor
    bb: torch.Tensor
    pp: torch.Tensor


def empty_channel_state(shape, device=None, dtype=torch.float32) -> WKVChannelState:
    return WKVChannelState(
        aa=torch.zeros(shape, dtype=dtype, device=device),
        bb=torch.zeros(shape, dtype=dtype, device=device),
        pp=torch.full(shape, -1e30, dtype=dtype, device=device),
    )


def wkv_step(k, v, state: WKVChannelState, w, u
             ) -> Tuple[torch.Tensor, WKVChannelState]:
    """One token. All arguments broadcast over [..., E]."""
    aa, bb, pp = state
    ww = u + k
    q = torch.maximum(pp, ww)
    e1 = torch.exp(pp - q)
    e2 = torch.exp(ww - q)
    y = (e1 * aa + e2 * v) / (e1 * bb + e2)

    ww2 = pp + w
    p2 = torch.maximum(ww2, k)
    f1 = torch.exp(ww2 - p2)
    f2 = torch.exp(k - p2)
    return y, WKVChannelState(aa=f1 * aa + f2 * v, bb=f1 * bb + f2, pp=p2)


def _mask_b(mask, k):
    """[T] (shared) or k.shape[:-1] mask -> broadcastable against k."""
    if mask.dim() == 1:
        return mask.reshape((mask.shape[0],) + (1,) * (k.dim() - 1))
    if tuple(mask.shape) != tuple(k.shape[:-1]):
        raise ValueError(f"mask {tuple(mask.shape)} does not fit k {tuple(k.shape)}")
    return mask[..., None]


def wkv_scan(k, v, state: WKVChannelState, w, u, mask=None
             ) -> Tuple[torch.Tensor, WKVChannelState]:
    """Sequential WKV. k, v: [T, ..., E]. mask: optional [T] bool; False
    positions are padding whose state update is skipped."""
    mb = None if mask is None else _mask_b(mask, k)
    ys = []
    for t in range(k.shape[0]):
        y, new = wkv_step(k[t], v[t], state, w, u)
        if mb is not None:
            new = WKVChannelState(*(torch.where(mb[t], n, c)
                                    for n, c in zip(new, state)))
        state = new
        ys.append(y)
    return torch.stack(ys), state


def _combine(left, right):
    """Compose two span maps (left earlier). A span map is
    A' = e^lam A + ca e^pc (the same for B with cb)."""
    lam1, ca1, cb1, pc1 = left
    lam2, ca2, cb2, pc2 = right
    shifted = pc1 + lam2
    pc_o = torch.maximum(shifted, pc2)
    e1 = torch.exp(shifted - pc_o)
    e2 = torch.exp(pc2 - pc_o)
    return lam1 + lam2, ca1 * e1 + ca2 * e2, cb1 * e1 + cb2 * e2, pc_o


def wkv_parallel(k, v, state: WKVChannelState, w, u, mask=None
                 ) -> Tuple[torch.Tensor, WKVChannelState]:
    """Parallel WKV over a sequence. k, v: [T, ..., E]; O(log T) depth.

    Each token's own map is (lam=w, ca=v, cb=1, pc=k): decay before its own
    contribution, the update order of wkv_step. An inclusive prefix scan
    gives the map of tokens [0..t]; folding the initial state through it
    gives the state after t, and the exclusive (pre-token) state feeds the
    output with the bonus term."""
    lam = torch.broadcast_to(w, k.shape).to(k.dtype)
    ca = v
    cb = torch.ones_like(k)
    pc = k
    if mask is not None:
        # padding tokens become exact identity maps: no decay, -inf payload
        mb = _mask_b(mask, k)
        lam = torch.where(mb, lam, torch.zeros_like(lam))
        pc = torch.where(mb, pc, torch.full_like(pc, -1e38))

    spans = (lam, ca, cb, pc)
    T = k.shape[0]
    d = 1
    while d < T:
        left = tuple(s[:-d] for s in spans)
        right = tuple(s[d:] for s in spans)
        merged = _combine(left, right)
        spans = tuple(torch.cat([s[:d], m], dim=0)
                      for s, m in zip(spans, merged))
        d *= 2
    lam_i, ca_i, cb_i, pc_i = spans

    aa0, bb0, pp0 = state
    pp_t = torch.maximum(pp0 + lam_i, pc_i)
    g1 = torch.exp(pp0 + lam_i - pp_t)
    g2 = torch.exp(pc_i - pp_t)
    aa_t = g1 * aa0 + g2 * ca_i
    bb_t = g1 * bb0 + g2 * cb_i

    aa_prev = torch.cat([aa0[None].expand((1,) + aa_t.shape[1:]), aa_t[:-1]], 0)
    bb_prev = torch.cat([bb0[None].expand((1,) + bb_t.shape[1:]), bb_t[:-1]], 0)
    pp_prev = torch.cat([pp0[None].expand((1,) + pp_t.shape[1:]), pp_t[:-1]], 0)

    ww = u + k
    q = torch.maximum(pp_prev, ww)
    e1 = torch.exp(pp_prev - q)
    e2 = torch.exp(ww - q)
    y = (e1 * aa_prev + e2 * v) / (e1 * bb_prev + e2)
    return y, WKVChannelState(aa=aa_t[-1], bb=bb_t[-1], pp=pp_t[-1])
