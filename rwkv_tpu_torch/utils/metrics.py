"""Lightweight observability: counters and timers (counterpart of
rwkv_tpu/utils/metrics.py, less its `trace()`, which wraps jax.profiler;
on the card, torch.profiler is the tool, as tools/decode_profile.py uses it).

A process-local metrics registry the pool feeds, and a `timed` context
manager.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from typing import Iterator


class Metrics:
    """Thread-safe counters + duration histograms (coarse)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = collections.defaultdict(float)
        self._timings: dict[str, list[float]] = collections.defaultdict(list)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            buf = self._timings[name]
            buf.append(seconds)
            if len(buf) > 4096:
                del buf[: len(buf) // 2]

    @contextlib.contextmanager
    def timed(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def snapshot(self) -> dict:
        with self._lock:
            out = {"counters": dict(self._counters), "timings": {}}
            for name, buf in self._timings.items():
                if not buf:
                    continue
                s = sorted(buf)
                out["timings"][name] = {
                    "count": len(s),
                    "p50": s[len(s) // 2],
                    "p90": s[int(len(s) * 0.9)],
                    "max": s[-1],
                    "total": sum(s),
                }
            return out

    def dump(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timings.clear()


# process-global default registry
metrics = Metrics()

