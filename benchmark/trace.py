"""The device trace of a window: torch.profiler's CUDA activity (CUPTI),
reduced to what the per-layer metrics read.

Only device activity is recorded (kernels, copies, sets), so the trace grows
with the device's work and not with the host's; the harness's own spans
(serve.py) are placed on the trace's clock, which is the host's
time.time_ns(), by the offset the window measured at its start.
"""

from __future__ import annotations

import collections
import dataclasses

import torch


class Tracer:
    """Starts CUDA activity tracing at the window's start, stops it at its
    close (serve.Server.run's on_start and on_end)."""

    def __init__(self):
        self._prof = None
        self.events = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        device = torch.autograd.DeviceType.CUDA
        self.events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in self._prof.profiler.kineto_results.events()
                       if e.device_type() == device]
        self._prof = None


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    by_name: dict            # kernel name -> (launches, seconds) wholly in the window
    steps: list              # (admitted, wall s, device busy s) of each step in the window
    idle_by_span: dict       # host span name -> idle device seconds


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(union, a, b, start=0):
    """Seconds of `union` inside [a, b], and the index to resume from."""
    total, i = 0, start
    while i < len(union) and union[i][1] <= a:
        i += 1
    j = i
    while j < len(union) and union[j][0] < b:
        total += min(b, union[j][1]) - max(a, union[j][0])
        j += 1
    return total, i


def reduce(events, win) -> Trace:
    """events: (name, start_ns, end_ns) of device activity; win: the window
    (serve.Window), whose spans are in perf_counter seconds."""
    to_ns = lambda t: int(t * 1e9) + win.ns_offset  # noqa: E731
    ws, we = to_ns(win.t_start), to_ns(win.t_end)
    clipped = [(n, max(a, ws), min(b, we)) for n, a, b in events if b > ws and a < we]
    by_name = collections.defaultdict(lambda: [0, 0.0])  # launches wholly inside
    for n, a, b in events:
        if a < ws or b > we:
            continue
        by_name[n][0] += 1
        by_name[n][1] += (b - a) / 1e9
    union = _union([(a, b) for _, a, b in clipped])
    busy = sum(b - a for a, b in union)

    step_busy, i = [], 0
    spans = []
    for s in win.steps:
        a, b = to_ns(s.t0), to_ns(s.t1)
        if a >= ws and b <= we:
            got, i = _overlap(union, a, b, i)
            step_busy.append((s.admitted, s.t1 - s.t0, got / 1e9))
        spans.append((a, b, "pool.step: admission + decode" if s.admitted else "pool.step: decode"))
    spans += [(to_ns(a), to_ns(b), "pool.submit") for a, b, _ in win.submits]
    spans.sort()

    gaps, last = [], ws
    for a, b in union:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if we > last:
        gaps.append((last, we))
    idle = collections.defaultdict(float)
    k = 0
    for a, b in gaps:
        mid = (a + b) // 2
        while k < len(spans) and spans[k][1] < mid:
            k += 1
        name = spans[k][2] if k < len(spans) and spans[k][0] <= mid else "client, between calls"
        idle[name] += (b - a) / 1e9
    return Trace(window_s=(we - ws) / 1e9, busy_s=busy / 1e9,
                 by_name={n: tuple(v) for n, v in by_name.items()},
                 steps=step_busy, idle_by_span=dict(idle))


def kernel(trace: Trace, fragment: str):
    """(launches, seconds) of the kernels whose name holds `fragment`, or None."""
    hits = [v for n, v in trace.by_name.items() if fragment in n]
    if not hits:
        return None
    return sum(c for c, _ in hits), sum(s for _, s in hits)


def breakdown(trace: Trace) -> dict:
    ops = sorted(trace.by_name.items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(trace.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, (_, s) in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
