"""End-to-end metrics of a window, from the client's side: each is taken over
all the work and all the time of the window, never as a median of chunks.

    output_tokens_per_s   every token delivered to any request in the window,
                          over the window's seconds
    stream_gap_p95_ms     the 95th percentile, over every request, of the gaps
                          between consecutive deliveries to the same request
                          that both fall in the window
    stream_gap_p50_ms     the median of the same gaps: the pace at which a
                          streaming reader gets its tokens between the
                          stalls that the p95 sees
    ttft_p95_ms           the 95th percentile, over every request submitted in
                          the window, of submit() to its first delivery; one
                          still waiting at the close counts its wait so far
    prompt_tokens_per_s   prompt tokens of the requests whose first token was
                          delivered in the window, over the window's seconds

A delivery is the return of the step() call that handed a request tokens.
A name in BENCHMARK.json may add a qualifier after a dot
(output_tokens_per_s.<qualifier>): the same quantity under a bound of its
own, for a class of cells whose runs spread differently.
"""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        return math.nan
    x = (len(v) - 1) * q / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def inside(t: float, win) -> bool:
    return win.t_start < t <= win.t_end


def output_tokens_per_s(win) -> float:
    n = sum(k for rec in win.recs for t, k in rec.deliveries if inside(t, win))
    return n / win.seconds


def stream_gaps(win) -> list[float]:
    gaps = []
    for rec in win.recs:
        ts = [t for t, _ in rec.deliveries if inside(t, win)]
        gaps.extend(b - a for a, b in zip(ts, ts[1:]))
    return gaps


def stream_gap_p95_ms(win) -> float:
    return 1e3 * percentile(stream_gaps(win), 95)


def stream_gap_p50_ms(win) -> float:
    return 1e3 * percentile(stream_gaps(win), 50)


def ttfts(win) -> list[float]:
    out = []
    for rec in win.recs:
        if win.t_start <= rec.t_submit < win.t_end:
            first = rec.t_first if rec.t_first is not None and rec.t_first <= win.t_end else win.t_end
            out.append(first - rec.t_submit)
    return out


def ttft_p95_ms(win) -> float:
    return 1e3 * percentile(ttfts(win), 95)


def prompt_tokens_per_s(win) -> float:
    n = sum(rec.prompt_tokens for rec in win.recs
            if rec.t_first is not None and inside(rec.t_first, win))
    return n / win.seconds


METRICS = {
    "output_tokens_per_s": output_tokens_per_s,
    "stream_gap_p95_ms": stream_gap_p95_ms,
    "stream_gap_p50_ms": stream_gap_p50_ms,
    "ttft_p95_ms": ttft_p95_ms,
    "prompt_tokens_per_s": prompt_tokens_per_s,
}


def quantity(name: str) -> str:
    """The quantity an end-to-end metric's name reads (its qualifier cut)."""
    return name.split(".", 1)[0]


def attempted_failed(win) -> tuple[int, int]:
    """Requests live in the window, and those of them that completed short of
    their max_tokens."""
    live = [r for r in win.recs if r.t_submit < win.t_end
            and (r.t_done is None or r.t_done > win.t_start)]
    failed = [r for r in live
              if (r.t_done is not None and len(r.tokens) != r.spec.max_tokens)]
    return len(live), len(failed)
