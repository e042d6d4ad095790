"""Lightweight observability: counters, timers and a span log (counterpart of
rwkv_tpu/utils/metrics.py, less its `trace()`, which wraps jax.profiler;
on the card, torch.profiler is the tool, as tools/decode_profile.py uses it).

A process-local metrics registry the pool feeds, and a `timed` context
manager. Each timing keeps an exact count, total and max over every sample,
and its p50 and p90 over the most recent RING samples. Each `timed` span is
also logged as (name, t0_ns, t1_ns) on time.perf_counter_ns(), in a log of
the most recent SPAN_LOG spans (`spans()`), so that a reader can place the
program's spans on another clock's timeline. A span is host time only: it
adds no device synchronisation and no profiler range.
"""

from __future__ import annotations

import collections
import json
import threading
import time

RING = 4096        # samples a timing's p50 and p90 are taken over
SPAN_LOG = 65536   # spans the log keeps

_clock = time.perf_counter_ns


class _Timing:
    __slots__ = ("count", "total", "max", "ring")

    def __init__(self):
        self.count, self.total, self.max = 0, 0.0, float("-inf")
        self.ring: collections.deque = collections.deque(maxlen=RING)


class _Span:
    __slots__ = ("_metrics", "_name", "_t0")

    def __init__(self, metrics: "Metrics", name: str):
        self._metrics, self._name = metrics, name

    def __enter__(self) -> None:
        self._t0 = _clock()

    def __exit__(self, *exc) -> bool:
        self._metrics._span(self._name, self._t0, _clock())
        return False


class Metrics:
    """Thread-safe counters, duration histograms and a span log."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = collections.defaultdict(float)
        self._timings: dict[str, _Timing] = collections.defaultdict(_Timing)
        self._spans: collections.deque = collections.deque(maxlen=SPAN_LOG)
        self._spans_total = 0  # spans ever logged: the log dropped the rest

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def _observe(self, name: str, seconds: float) -> None:
        t = self._timings[name]
        t.count += 1
        t.total += seconds
        t.max = max(t.max, seconds)
        t.ring.append(seconds)

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._observe(name, seconds)

    def _span(self, name: str, t0_ns: int, t1_ns: int) -> None:
        with self._lock:
            self._observe(name, (t1_ns - t0_ns) * 1e-9)
            self._spans.append((name, t0_ns, t1_ns))
            self._spans_total += 1

    def timed(self, name: str) -> _Span:
        """A span: its duration is observed under `name`, and it is logged."""
        return _Span(self, name)

    def spans(self, since_ns: int = 0) -> tuple[list, bool]:
        """The logged spans (name, t0_ns, t1_ns) that ended at or after
        since_ns, in the order they ended, and whether that is all of them
        (False once the log has overwritten one)."""
        with self._lock:
            log = list(self._spans)
            dropped = self._spans_total - len(log)
        complete = dropped == 0 or log[0][2] < since_ns
        return [s for s in log if s[2] >= since_ns], complete

    def snapshot(self) -> dict:
        """Counters, and per timing its count, total and max over every
        sample and its p50 and p90 over the last RING. While the ring holds
        every sample, the figures are the JAX package's (the total summed in
        sorted order)."""
        with self._lock:
            out = {"counters": dict(self._counters), "timings": {}}
            for name, t in self._timings.items():
                s = sorted(t.ring)
                whole = t.count == len(s)
                out["timings"][name] = {
                    "count": t.count,
                    "p50": s[len(s) // 2],
                    "p90": s[int(len(s) * 0.9)],
                    "max": t.max,
                    "total": sum(s) if whole else t.total,
                }
            return out

    def dump(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timings.clear()
            self._spans.clear()
            self._spans_total = 0


# process-global default registry
metrics = Metrics()
