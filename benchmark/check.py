"""How `correct` is decided: the served path's own outputs, judged against
the plain reference (benchmark/reference/) once the window has closed.

Lanes judged: every request the pool holds at the close (each with its
prompt and the tokens served so far), and a sample, drawn from the
seed, of the requests finished with every token kept (the traffic's checked
ones, tau 1.0): taken in a seeded order until they hold JUDGED_TOKENS served
tokens or none is left, with the one that was served the most tokens in it. The
reference ingests each lane's prompt (its own encoding of the text) and the
served tokens but the last, from the empty state.

Numbers compared, each with its limit from checks/<workload>.json:

  tokenizer_mismatch  lanes whose prompt ids from the program's tokenizer
                      differ from the reference tokenizer's (exact: limit 0)
  state_err           the state each slot holds at the close against the
                      reference's after the same tokens: the largest, over
                      slots, of the family's state_err (families/<family>.py
                      says what it compares), a share of the reference
  gap                 the widest gap, in logits, by which a served token of
                      a checked lane lies below the reference's best. A
                      checked request samples with every token kept, so its
                      token is the argmax of logit + temp * Gumbel noise,
                      the noise drawn by the request's torch.Generator from
                      its seed, one torch.rand(Vp) a token; the reference
                      draws the same noise, and the gap is max_j (l_j + temp
                      G_j) - (l_s + temp G_s) over its logits l. It is 0
                      where the reference picks the served token, and
                      greedy decoding's gap at temp 0.

The control puts the reference in the family's CONTROL precision (the step
below the configuration's) in the program's place: its state is compared
with the plain reference's, and at each position the token its own logits
put first (with the same noise) is judged by the same gap.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

NUMBERS = ("tokenizer_mismatch", "state_err", "gap")
JUDGED_TOKENS = 1000  # served tokens of finished requests that a run judges
BAN = (0,)  # the pool's default ban_tokens


@dataclasses.dataclass
class Lane:
    rec: object                 # serve.Rec
    state: dict | None          # the slot's state at the close (in flight), else None


def pick_lanes(recs, in_flight: dict, states: dict, seed: int) -> list[Lane]:
    lanes = [Lane(r, states[r.rid]) for r in recs if r.rid in in_flight]
    done = sorted((r for r in recs if r.t_done is not None and r.spec.checked),
                  key=lambda r: r.spec.index)
    if done:
        rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 7919]))
        take = {max(range(len(done)), key=lambda i: len(done[i].tokens))}
        for i in rng.permutation(len(done)).tolist():
            if sum(len(done[j].tokens) for j in take) >= JUDGED_TOKENS:
                break
            take.add(i)
        lanes += [Lane(done[i], None) for i in sorted(take)]
    return lanes


def noise(seed: int, n: int, vp: int, device) -> torch.Tensor:
    """The Gumbel noise of a request's n tokens, float64 [n, Vp]."""
    g = torch.Generator(device=device)
    g.manual_seed(seed & 0xFFFFFFFFFFFFFFFF)
    u = torch.stack([torch.rand(vp, generator=g, device=device) for _ in range(n)])
    u = u.clamp_min(torch.finfo(torch.float32).tiny).double()
    return -torch.log(-torch.log(u))


def scores(logits: torch.Tensor, G: torch.Tensor, temp: float) -> torch.Tensor:
    s = logits.double() + temp * G
    s[:, list(BAN)] = -math.inf
    return s


def worse(a: float, b: float) -> float:
    """max(a, b), where NaN counts as infinitely wrong."""
    return math.inf if math.isnan(b) else max(a, b)


def judge(lanes: list[Lane], family, weights: dict, cfg: dict, ref_tok, device,
          control: bool = False) -> dict:
    """The numbers of NUMBERS for these lanes, by the reference of `family`
    (spec.family); with control=True also the control's, under the same
    names prefixed "control.". Each lane is [prompt ids, served tokens]."""
    prompts = [ref_tok.encode(l.rec.spec.text) for l in lanes]
    out = {"tokenizer_mismatch": sum(p != list(l.rec.program.prompt_ids)
                                     for p, l in zip(prompts, lanes))}
    seqs = [p + l.rec.tokens[:-1] for p, l in zip(prompts, lanes)]
    starts = [len(p) - 1 for p in prompts]
    ref = family.reference(weights, cfg).run(seqs, starts)
    ctl = family.reference(weights, cfg, family.CONTROL).run(seqs, starts) if control else None
    vp = family.vocab_rows(weights)
    res = {"state_err": 0.0, "gap": 0.0, "control.state_err": 0.0, "control.gap": 0.0}
    judged = 0
    for i, lane in enumerate(lanes):
        logits, st = ref[i]
        if lane.state is not None:
            res["state_err"] = worse(res["state_err"], family.state_err(lane.state, st, weights))
            if ctl:
                res["control.state_err"] = worse(res["control.state_err"],
                                                 family.state_err(ctl[i][1], st, weights))
        if not lane.rec.spec.checked:
            continue
        if min(lane.rec.tokens) < 0 or max(lane.rec.tokens) >= vp:
            res["gap"] = math.inf
            continue
        served = torch.tensor(lane.rec.tokens, device=logits.device)
        G = noise(lane.rec.spec.seed, len(served), vp, logits.device)
        s = scores(logits, G, lane.rec.spec.temp)
        best = s.max(dim=1).values
        rows = torch.arange(len(served), device=logits.device)
        res["gap"] = worse(res["gap"], float((best - s[rows, served]).max()))
        judged += len(served)
        if ctl:
            pick = scores(ctl[i][0], G, lane.rec.spec.temp).argmax(dim=1)
            res["control.gap"] = worse(res["control.gap"], float((best - s[rows, pick]).max()))
    out.update(state_err=res["state_err"], gap=res["gap"], tokens_judged=judged,
               lanes=len(lanes), states_judged=sum(l.state is not None for l in lanes))
    if control:
        out.update({k: v for k, v in res.items() if k.startswith("control.")})
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that the cell's
    limits name; a lane set with no state or no checked token judged is not
    correct."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in NUMBERS if n in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    ok = ok and numbers["tokens_judged"] > 0 and numbers["states_judged"] > 0
    return ok, checks
