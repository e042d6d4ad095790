"""RWKV-4 in plain PyTorch: the benchmark's reference forward pass.

It reads the weights as the benchmark made them (benchmark/weights.py:
int8 codes, a scale and an offset per input channel) and nothing the program
made. Every matrix is widened to float32 (W = code * scale + offset) and
multiplied in float32 with TF32 off; precision="tf32" rounds both operands
of every product to TF32 first (10 mantissa bits, round to nearest even),
which is the control of the comparison. LayerNorm is float32 with
population variance and the configuration's epsilon.

The WKV recurrence runs in float64 in its closed form over a whole sequence,
from the empty state (A = B = 0): before token t,

    A_t = sum_{i<t} e^{w (t-1-i) + k_i} v_i,   B_t = sum_{i<t} e^{w (t-1-i) + k_i}
    y_t = (A_t + e^{u + k_t} v_t) / (B_t + e^{u + k_t})

with c_i = k_i - w (i + 1), so that A_t = e^{w t} sum_{i<t} e^{c_i} v_i: the
sums are running log-sum-exps of c_i + log v_i, split by the sign of v. The
state after T tokens is given in the served format (aa, bb, pp) with A =
aa e^pp, B = bb e^pp and pp the running maximum of the recurrence,
pp_T = w T + max_{i<T} c_i.

Sequences ("lanes") of different lengths are padded at their ends and run
in groups of similar length, each layer's weights widened once for all of
them; padding never reaches a valid position, since every operation is
causal.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

LEAVES = ("xy", "aa", "bb", "pp", "dd")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _exact_float32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    def __init__(self, weights: dict, cfg: dict, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.w, self.cfg, self.precision = weights, cfg, precision
        self.eps = float(cfg["layer_norm_epsilon"])

    def dense(self, name: str, layer: int | None = None) -> torch.Tensor:
        codes, scale, offset = self.w[name]
        if layer is not None:
            codes, scale, offset = codes[layer], scale[layer], offset[layer]
        W = codes.float() * scale[:, None] + offset[:, None]
        return round_tf32(W) if self.precision == "tf32" else W

    def mm(self, x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32":
            x = round_tf32(x)
        return x @ W

    def ln(self, x, w, b):
        return F.layer_norm(x, (x.shape[-1],), w, b, self.eps)

    @staticmethod
    def wkv(k, v, w, u, lengths):
        """k, v [T, R, E] float32; w, u [E]; lengths [R] (long). Returns y
        [T, R, E] float32 and the state (aa, bb, pp) [R, E] float64 after
        each lane's last valid token."""
        T = k.shape[0]
        k, v, w, u = k.double(), v.double(), w.double(), u.double()
        t = torch.arange(T, device=k.device, dtype=torch.float64)[:, None, None]
        c = k - w * (t + 1)
        neg_inf = torch.tensor(float("-inf"), dtype=torch.float64, device=k.device)
        lp = c + torch.log(v.clamp(min=0))
        ln_ = c + torch.log((-v).clamp(min=0))
        Pp, Pn, Pb = (torch.logcumsumexp(a, dim=0) for a in (lp, ln_, c))

        def exclusive(P):
            return torch.cat([neg_inf.expand(1, *P.shape[1:]), P[:-1]], dim=0)

        Sp, Sn, Sb = exclusive(Pp), exclusive(Pn), exclusive(Pb)
        g = u + k
        tw = w * t
        m = torch.maximum(tw + torch.maximum(torch.maximum(Sp, Sn), Sb), g)
        num = torch.exp(tw + Sp - m) - torch.exp(tw + Sn - m) + torch.exp(g - m) * v
        den = torch.exp(tw + Sb - m) + torch.exp(g - m)
        y = (num / den).float()

        last = (lengths - 1).to(k.device)[None, :, None].expand(1, -1, k.shape[2])
        pick = lambda a: a.gather(0, last)[0]  # noqa: E731
        M = pick(torch.cummax(c, dim=0).values)
        aa = torch.exp(pick(Pp) - M) - torch.exp(pick(Pn) - M)
        bb = torch.exp(pick(Pb) - M)
        pp = w * lengths.to(k.device, torch.float64)[:, None] + M
        return y, (aa, bb, pp)

    def run(self, lanes: list[list[int]], logits_from: list[int], lanes_per_group: int = 8):
        """lanes: token ids of each sequence, from the empty state;
        logits_from[r]: the first position whose logits are returned for lane
        r. Returns, per lane, (logits [len - logits_from, Vp] float32, state:
        dict of LEAVES, each [L, E] float64) after the whole lane."""
        with _exact_float32(), torch.no_grad():
            return self._run(lanes, logits_from, lanes_per_group)

    def _run(self, lanes, logits_from, lanes_per_group):
        w, L = self.w, self.cfg["num_hidden_layers"]
        dev = w["emb"].device
        order = sorted(range(len(lanes)), key=lambda r: -len(lanes[r]))
        groups = [order[i:i + lanes_per_group] for i in range(0, len(order), lanes_per_group)]
        xs, lens, states = [], [], []
        for grp in groups:
            T = len(lanes[grp[0]])
            ids = torch.zeros((T, len(grp)), dtype=torch.long)
            for j, r in enumerate(grp):
                ids[: len(lanes[r]), j] = torch.tensor(lanes[r])
            xs.append(self.ln(w["emb"][ids.to(dev)], w["ln0_w"], w["ln0_b"]))
            lens.append(torch.tensor([len(lanes[r]) for r in grp], device=dev))
            states.append({leaf: [] for leaf in LEAVES})

        def last_valid(a, n):  # a [T, R, E] at each lane's last position
            return a.gather(0, (n - 1)[None, :, None].expand(1, -1, a.shape[2]))[0]

        def shift(xx):  # token shift from the empty state (zeros)
            return torch.cat([torch.zeros_like(xx[:1]), xx[:-1]], dim=0)

        for i in range(L):
            Wk, Wv, Wr, Wo = (self.dense(n, i) for n in
                              ("att_key", "att_value", "att_receptance", "att_output"))
            for x, n, st in zip(xs, lens, states):
                xx = self.ln(x, w["ln1_w"][i], w["ln1_b"][i])
                prev = shift(xx)
                mix = lambda m: m * xx + (1 - m) * prev  # noqa: E731
                k = self.mm(mix(w["att_mix_k"][i]), Wk)
                v = self.mm(mix(w["att_mix_v"][i]), Wv)
                r = self.mm(mix(w["att_mix_r"][i]), Wr)
                y, (aa, bb, pp) = self.wkv(k, v, w["att_decay"][i], w["att_bonus"][i], n)
                x += self.mm(torch.sigmoid(r) * y, Wo)
                st["xy"].append(last_valid(xx, n).double())
                st["aa"].append(aa)
                st["bb"].append(bb)
                st["pp"].append(pp)
            del Wk, Wv, Wr, Wo
            Fk, Fv, Fr = (self.dense(n, i) for n in ("ffn_key", "ffn_value", "ffn_receptance"))
            for x, n, st in zip(xs, lens, states):
                xx = self.ln(x, w["ln2_w"][i], w["ln2_b"][i])
                prev = shift(xx)
                gate = torch.sigmoid(self.mm(w["ffn_mix_r"][i] * xx + (1 - w["ffn_mix_r"][i]) * prev, Fr))
                kk = torch.square(torch.relu(self.mm(w["ffn_mix_k"][i] * xx
                                                     + (1 - w["ffn_mix_k"][i]) * prev, Fk)))
                x += gate * self.mm(kk, Fv)
                st["dd"].append(last_valid(xx, n).double())
            del Fk, Fv, Fr

        Wh = self.dense("head")
        out = [None] * len(lanes)
        for grp, x, st in zip(groups, xs, states):
            for j, r in enumerate(grp):
                rows = x[logits_from[r]: len(lanes[r]), j]
                logits = self.mm(self.ln(rows, w["ln_out_w"], w["ln_out_b"]), Wh) + w["logit_bias"]
                state = {leaf: torch.stack([a[j] for a in st[leaf]]) for leaf in LEAVES}
                out[r] = (logits, state)
        return out
