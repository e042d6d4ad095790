"""Pins of the harness's arithmetic for RWKV-4, recorded on the CPU before its
parts moved behind benchmark/families/rwkv4.py: the digest of the weights
that make() draws, and judge()'s numbers on one fixed set of lanes, for
cells.py's tiny cells. The lanes are built from the traffic and the
reference alone (no run of the program), so only the harness moves them."""

import hashlib
import types

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.reference.model import Reference
from benchmark.tests.cells import tiny
from benchmark.traffic import Traffic

SEED = 2 ** 33 + 4242
STATE_NOISE = 1e-5  # relative noise on the in-flight lanes' states

W_TINY = "0717e981e8979a094dd04fb7fb1bd7f5897435d53169b10bd7c247fad23e8b63"
CHAT = {"tokenizer_mismatch": 1, "state_err": 1.4479756816604025e-05, "gap": 20.443717061419946,
        "tokens_judged": 19, "lanes": 6, "states_judged": 3,
        "control.state_err": 0.0008347026552165349, "control.gap": 0.0}
PINS = {  # the parent tree's readings (CPU, torch 2.13)
    "rwkv4-14b-q8.chat": (W_TINY, CHAT),
    "rwkv4-430m-q8.chat": (W_TINY, CHAT),
    "rwkv4-430m-q8.longprompt": (W_TINY, {
        "tokenizer_mismatch": 1, "state_err": 1.5117102395909549e-05,
        "gap": 22.952997594648973, "tokens_judged": 23, "lanes": 6, "states_judged": 3,
        "control.state_err": 0.000882382109173637, "control.gap": 0.0}),
}


def digest(weights: dict) -> str:
    """sha256 over every tensor of the weights, in the order of their names."""
    h = hashlib.sha256()
    for name in sorted(weights):
        parts = weights[name] if isinstance(weights[name], tuple) else (weights[name],)
        for t in parts:
            h.update(f"{name} {t.dtype} {tuple(t.shape)}".encode())
            h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def fixed_lanes(cell, weights, tok):
    """Six lanes, the first three checked requests of the cell's traffic and
    the first three others: each served a seeded run of ids; the first,
    second and fourth held in a slot at the close, with the reference's
    state moved by STATE_NOISE; the fifth's program ids one short (a
    tokenizer mismatch)."""
    traffic = Traffic(cell.traffic, SEED, tok)
    rng = np.random.default_rng(SEED)
    first = [traffic.request(i) for i in range(16)]
    specs = [s for s in first if s.checked][:3] + [s for s in first if not s.checked][:3]
    prompts = [tok.encode(s.text) for s in specs]
    served = [rng.integers(1, cell.config["vocab_size"], size=min(s.max_tokens, 10)).tolist()
              for s in specs]
    ref = Reference(weights, cell.config).run(
        [p + t[:-1] for p, t in zip(prompts, served)], [len(p) - 1 for p in prompts])
    g = torch.Generator().manual_seed(SEED)
    lanes = []
    for i, (s, p, t) in enumerate(zip(specs, prompts, served)):
        state = None
        if i in (0, 1, 3):
            state = {k: v * (1 + STATE_NOISE * torch.randn(v.shape, generator=g,
                                                          dtype=torch.float64))
                     for k, v in ref[i][1].items()}
        ids = p[:-1] if i == 4 else p
        rec = types.SimpleNamespace(spec=s, program=types.SimpleNamespace(prompt_ids=ids),
                                    tokens=t)
        lanes.append(check.Lane(rec, state))
    return lanes


@pytest.mark.parametrize("name", sorted(PINS))
def test_weights_and_judge_are_pinned(name):
    cell = tiny(name)
    fam = cell.family
    w = fam.make(cell.config, SEED, "cpu")
    assert digest(w) == PINS[name][0]
    tok = fam.tokenizer(cell.config)
    lanes = fixed_lanes(cell, w, tok)
    got = check.judge(lanes, fam, w, cell.config, tok, "cpu", control=True)
    assert got == PINS[name][1]  # bit for bit
