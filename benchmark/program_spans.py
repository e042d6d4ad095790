"""The program's own spans over a window: the span log of the port's metrics
registry (rwkv_tpu_torch/utils/metrics.py, `metrics.spans()`), on
time.perf_counter_ns(), the clock of the window's perf_counter() seconds.
A program without a span log reads as nothing."""

from __future__ import annotations

import collections


def window_spans(win) -> dict | None:
    """{name: [seconds of each span that overlaps the window, clipped to it]},
    or None when the program keeps no span log or its log no longer reaches
    back to the window's start."""
    from rwkv_tpu_torch.utils.metrics import metrics

    read = getattr(metrics, "spans", None)
    if read is None:
        return None
    ws, we = round(win.t_start * 1e9), round(win.t_end * 1e9)
    spans, complete = read(ws)
    if not complete:
        return None
    out = collections.defaultdict(list)
    for name, a, b in spans:
        if a < we:
            out[name].append((min(b, we) - max(a, ws)) / 1e9)
    return out
