"""The port's metrics registry (rwkv_tpu_torch/utils/metrics.py) and the
spans, counters and stamps the pool (runtime/pool.py) feeds it, on the CPU:
exact aggregates past the timing ring, the bounded span log, spans nested
inside the caller's interval around each pool call, and admission's token
counts against the prompts' lengths."""

import math
import time

import pytest
import torch

from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.rwkv4 import init_params, params_to, quantize_params
from rwkv_tpu_torch.runtime.pool import InferencePool
from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer
from rwkv_tpu_torch.utils import metrics as metrics_mod
from rwkv_tpu_torch.utils.metrics import Metrics, metrics


@pytest.fixture(scope="module")
def tok():
    return BPETokenizer.load()


@pytest.fixture(scope="module")
def params():
    cfg = RWKVConfig(n_layer=2, n_embd=16)
    return params_to(quantize_params(init_params(cfg, torch.Generator().manual_seed(3))), "cpu")


@pytest.fixture
def registry():
    metrics.reset()
    yield metrics
    metrics.reset()


def test_timed_aggregates_exact_past_the_ring(monkeypatch):
    """10^5 spans: count, total and max over all of them (the old buffer
    kept 2,049 to 4,096), p50 and p90 over the last RING."""
    n = 100_000
    durations = [(i * 7919 % 1000 + 1) * 1000 for i in range(n)]  # ns
    stamps = iter(t for d in durations for t in (0, d))
    monkeypatch.setattr(metrics_mod, "_clock", lambda: next(stamps))
    m = Metrics()
    for _ in range(n):
        with m.timed("op"):
            pass
    got = m.snapshot()["timings"]["op"]
    seconds = [d * 1e-9 for d in durations]
    assert got["count"] == n
    assert got["max"] == max(seconds)
    assert got["total"] == pytest.approx(math.fsum(seconds), rel=1e-12)
    last = sorted(seconds[-metrics_mod.RING:])
    assert got["p50"] == last[len(last) // 2] and got["p90"] == last[int(len(last) * 0.9)]


def test_span_log_is_bounded_and_reports_its_overwritten_start():
    m = Metrics()
    n = metrics_mod.SPAN_LOG + 4464
    for i in range(n):
        m._span("s", 10 * i, 10 * i + 5)
    held, complete = m.spans()
    assert len(held) == metrics_mod.SPAN_LOG and not complete
    assert held[0] == ("s", 44640, 44645) and held[-1] == ("s", 10 * (n - 1), 10 * (n - 1) + 5)
    # a window that opened after the oldest held span ended lost nothing
    held, complete = m.spans(44646)
    assert complete and len(held) == metrics_mod.SPAN_LOG - 1
    assert m.snapshot()["timings"]["s"]["count"] == n
    assert "spans" not in m.snapshot()
    m.reset()
    assert m.spans() == ([], True)


def test_timed_logs_on_the_perf_counter_clock():
    m = Metrics()
    t0 = time.perf_counter_ns()
    with m.timed("a"):
        with m.timed("b"):
            pass
    t1 = time.perf_counter_ns()
    logged, _ = m.spans()
    assert [name for name, _, _ in logged] == ["b", "a"]  # in the order they end
    spans = {name: (s, e) for name, s, e in logged}
    assert t0 <= spans["a"][0] <= spans["b"][0] <= spans["b"][1] <= spans["a"][1] <= t1


def _served(params, tok, prompts, **kw):
    """A pool over `prompts` (max_tokens 3 each), its requests, and each
    admission burst's prompt lengths; every call's interval on
    perf_counter_ns beside the spans logged inside it."""
    pool = InferencePool(params, tok, **kw)
    bursts = []
    admit = pool._admit_batch

    def recording(reqs, slots):
        bursts.append([len(r.prompt_ids) for r in reqs])
        return admit(reqs, slots)

    pool._admit_batch = recording
    calls, reqs = [], []
    for p in prompts:
        t0 = time.perf_counter_ns()
        pool.submit(p, max_tokens=3, seed=len(reqs))
        calls.append(("submit", t0, time.perf_counter_ns()))
        reqs.append(pool._queue[-1])
    while pool.pending:
        t0 = time.perf_counter_ns()
        pool.step()
        calls.append(("step", t0, time.perf_counter_ns()))
    return pool, reqs, bursts, calls


PROMPTS = ["Hello", "The quick brown fox jumps over the lazy dog " * 3,
           "In a hole in the ground there lived a hobbit.", "a b c d e f g h i j k l",
           "Once upon a time", "x" * 40]


def test_pool_spans_nest_inside_each_call(params, tok, registry):
    _, _, _, calls = _served(params, tok, PROMPTS, max_streams=4, prefill_bucket=8,
                             step_chunk=2)
    spans, complete = registry.spans()
    assert complete and spans
    for name, a, b in spans:
        kind = "submit" if name.startswith("pool.submit") else "step"
        assert any(k == kind and t0 <= a <= b <= t1 for k, t0, t1 in calls), name
    admits = [(a, b) for name, a, b in spans if name == "pool.admit"]
    for name, a, b in spans:
        if name.startswith("pool.admit."):
            assert any(a0 <= a <= b <= b0 for a0, b0 in admits), name
    names = {name for name, _, _ in spans}
    assert names == {"pool.submit.encode", "pool.admit", "pool.admit.pack",
                     "pool.admit.prefill", "pool.admit.sample", "pool.admit.read",
                     "pool.admit.emit", "pool.decode.prep", "pool.decode.replay",
                     "pool.decode.read", "pool.decode.emit"}
    snap = registry.snapshot()
    count = {name: t["count"] for name, t in snap["timings"].items()}
    assert count["pool.submit.encode"] == len(PROMPTS)
    assert count["pool.admit.pack"] == count["pool.admit.prefill"] == \
        snap["counters"]["pool.prefill.chunks"]
    for part in ("prep", "replay", "read", "emit"):
        assert count[f"pool.decode.{part}"] == snap["counters"]["pool.steps"]


def test_prefill_counters_match_the_prompts(params, tok, registry):
    pool, reqs, bursts, _ = _served(params, tok, PROMPTS, max_streams=4, prefill_bucket=8)
    c = registry.snapshot()["counters"]
    lengths = [len(r.prompt_ids) for r in reqs]
    assert c["pool.submit.tokens"] == sum(lengths) == c["pool.prefill.tokens"]
    assert c["pool.admit.requests"] == len(PROMPTS) == sum(map(len, bursts))
    K = pool.prefill_bucket
    chunks = [-(-max(b) // K) for b in bursts]
    widths = [next(w for w in pool._widths if w >= len(b)) for b in bursts]
    assert c["pool.prefill.chunks"] == sum(chunks) and len(bursts) > 1
    assert c["pool.prefill.lane_tokens"] == sum(K * w * n for w, n in zip(widths, chunks))


def test_requests_carry_submit_and_admit_stamps(params, tok, registry):
    _, reqs, _, calls = _served(params, tok, PROMPTS, max_streams=2, prefill_bucket=16)
    for req in reqs:
        assert req.t_admit is not None and req.t_submit <= req.t_admit
    submits = [(t0, t1) for k, t0, t1 in calls if k == "submit"]
    for req, (t0, t1) in zip(reqs, submits):
        # perf_counter()'s float against perf_counter_ns(), to a microsecond
        assert t0 - 1e3 <= req.t_submit * 1e9 <= t1 + 1e3
