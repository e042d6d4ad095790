"""The one traffic generator: it reads a mix's parameters (benchmark/traffic/
<name>.json) and yields the requests of a run from the seed, and when they
arrive.

A mix gives `clients` (the closed loop's size), the lognormal `median`,
`sigma`, `min` and `max` of `prompt_tokens` and `output_tokens`, and the
sampling's `temp` and `tau`. Requests come in cycles of CYCLE. Every cycle
holds the same sizes: the prompt and output lengths at the quantiles
(i + 0.5) / CYCLE of the lognormal, rounded and clipped to [min, max]; and
CHECKED of its requests are sampled with tau 1.0 (every token kept, so the
served tokens can be replayed exactly; see check.py), the others with
`tau`. Each cycle's order (the lengths, their pairing, the checked places)
is a shuffle fixed by ORDER_SEED and the cycle's number, the same for every
run: in a closed loop the order decides which prompts share an admission,
and so how much padding it computes. The run's seed draws each
prompt's words and each request's sampling seed. A prompt is a run of word
tokens, drawn uniformly from the vocab's entries that are a space and one
or more letters (any script; unicodedata's L categories), decoded by the
benchmark's own tokenizer: each such word encodes back to its one id, so a
prompt drawn with n tokens is n tokens long to any correct tokenizer. So
every seed asks for the same work with other text, and a seed gives the
same requests every time.

Arrivals. A mix without `arrivals` is a closed loop of `clients`: each
sends its next request as soon as its last one completes. A mix with
`"arrivals": {"rate_per_s": r, "cv": c}` is an open loop: request i
arrives at the i-th offset of a schedule, whatever the system has
finished; the gaps between arrivals are gamma with mean 1 / r and shape
1 / c^2, so a coefficient of variation c. `cv` defaults to 1, which is
Poisson (exponential gaps); c > 1 gives bursts (BurstGPT's fit). The
first request arrives at
offset 0; the gaps come from the run's seed, on a stream of their own
(ARRIVAL_SEED), so they do not move the requests' text.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Iterator

import numpy as np

from benchmark.reference.tokenizer import char_kind

CYCLE = 16
CHECKED = 4        # requests of a cycle sampled with every token kept
CHECKED_TAU = 1.0  # check.py replays such a request's tokens exactly
ORDER_SEED = 19
ARRIVAL_SEED = 4099
ARRIVAL_BLOCK = 1024  # gaps drawn a call


@dataclasses.dataclass
class RequestSpec:
    index: int
    text: str
    drawn_tokens: int
    max_tokens: int
    temp: float
    tau: float
    seed: int
    checked: bool


def is_word(piece: bytes) -> bool:
    """A space followed by one or more letters."""
    try:
        text = piece.decode("utf-8")
    except UnicodeDecodeError:
        return False
    return len(text) > 1 and text[0] == " " and all(char_kind(c) == "L" for c in text[1:])


def lengths(dist: dict, n: int) -> list[int]:
    """The n lengths of one cycle (module docstring)."""
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        v = round(dist["median"] * math.exp(dist["sigma"] * z))
        out.append(min(max(v, dist["min"]), dist["max"]))
    return out


def arrival_offsets(arrivals: dict, seed: int) -> Iterator[float]:
    """Seconds from the schedule's start at which requests 0, 1, 2, ...
    arrive (module docstring), without end."""
    rate, cv = float(arrivals["rate_per_s"]), float(arrivals.get("cv", 1.0))
    if not (rate > 0 and cv > 0):
        raise ValueError(f"arrivals {arrivals}: rate_per_s and cv must be > 0")
    shape = 1.0 / (cv * cv)
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), ARRIVAL_SEED]))
    t = 0.0
    yield t
    while True:
        for gap in rng.gamma(shape, 1.0 / (rate * shape), size=ARRIVAL_BLOCK).tolist():
            t += gap
            yield t


class Traffic:
    def __init__(self, mix: dict, seed: int, tokenizer):
        self.mix = mix
        self.seed = seed % (1 << 64)
        self.tok = tokenizer
        self.n = CYCLE
        self._prompts = lengths(mix["prompt_tokens"], self.n)
        self._outputs = lengths(mix["output_tokens"], self.n)
        self._pieces = [tokenizer.token_bytes(i) for i in range(tokenizer.vocab_size)]
        self._words = np.array([i for i, b in enumerate(self._pieces) if is_word(b)])
        self._cycles: dict[int, list[RequestSpec]] = {}

    def _cycle(self, c: int) -> list[RequestSpec]:
        order = np.random.default_rng(np.random.SeedSequence([ORDER_SEED, c]))
        prompts = order.permutation(self._prompts)
        outputs = order.permutation(self._outputs)
        checked = order.permutation(self.n) < CHECKED
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, c]))
        specs = []
        for j in range(self.n):
            ids = self._words[rng.integers(0, len(self._words), size=int(prompts[j]))]
            text = b"".join(self._pieces[i] for i in ids).decode("utf-8")
            specs.append(RequestSpec(
                index=c * self.n + j, text=text, drawn_tokens=int(prompts[j]),
                max_tokens=int(outputs[j]), temp=float(self.mix["temp"]),
                tau=CHECKED_TAU if checked[j] else float(self.mix["tau"]),
                seed=int(rng.integers(0, 1 << 63)), checked=bool(checked[j])))
        return specs

    def arrivals(self) -> Iterator[float] | None:
        """The open loop's arrival offsets (arrival_offsets), or None for a
        closed loop."""
        if "arrivals" not in self.mix:
            return None
        return arrival_offsets(self.mix["arrivals"], self.seed)

    def request(self, index: int) -> RequestSpec:
        c = index // self.n
        if c not in self._cycles:
            self._cycles[c] = self._cycle(c)
        return self._cycles[c][index % self.n]
