"""The readers of the program's own spans, counters and stamps
(layer_metrics/*.py over program_spans.py) on a hand-made window and a
filled span log: each reads what it names, and nothing from an empty window;
those of spans read nothing once the log no longer reaches back to the
window's start, and nothing from a program that keeps no log."""

import types

import pytest

from benchmark import run, spec
from benchmark.serve import Window
from rwkv_tpu_torch.utils import metrics as metrics_mod

T0, T1 = 1000.0, 1010.0  # the window, perf_counter seconds
NS = 1_000_000_000

SPANS = [  # name, start and end in seconds after the window opened
    ("pool.submit.encode", -0.5, -0.4),   # before the window: not read
    ("pool.submit.encode", 0.1, 0.102),
    ("pool.admit", 0.2, 0.5),
    ("pool.admit.read", 0.45, 0.5),
    ("pool.submit.encode", 0.6, 0.601),
    ("pool.decode.emit", 1.0, 1.001),
    ("pool.admit", 2.0, 2.2),
    ("pool.admit.read", 2.1, 2.2),
    ("pool.decode.emit", 3.0, 3.003),
    ("pool.decode.emit", 10.5, 10.6),    # after the window: not read
]
COUNTERS = {"pool.prefill.tokens": 400, "pool.prefill.lane_tokens": 1024,
            "pool.submit.tokens": 600}
EXPECTED = {
    "prefill_pad_pct": 100 * (1 - 400 / 1024),
    "admit_host_ms_per_ktok": 1e6 * ((0.3 + 0.2) - (0.05 + 0.1)) / 400,
    "encode_ms_per_ktok": 1e6 * (0.002 + 0.001) / 600,
    "pool_emit_ms.decode": 1e3 * (0.001 + 0.003) / 2,
    "queue_wait_p95_ms": 1e3 * (0.01 + 0.95 * (0.2 - 0.01)),
}
NAMES = sorted(EXPECTED) + [n + ".host_bound" for n in
                            ("prefill_pad_pct", "admit_host_ms_per_ktok", "pool_emit_ms.decode")]
OF_SPANS = [n for n in NAMES if not n.startswith(("prefill_pad_pct", "queue_wait"))]


def rec(t_submit, t_admit):
    return types.SimpleNamespace(program=types.SimpleNamespace(t_submit=t_submit, t_admit=t_admit))


RECS = [rec(T0 - 0.3, T0 - 0.1),                 # admitted before the window: not read
        rec(T0 + 0.1, T0 + 0.11), rec(T0 + 0.2, T0 + 0.4),
        rec(T0 + 9.9, None)]                     # still queued at the close


def ctx(recs=RECS, counters=COUNTERS):
    win = Window(T0, T1, list(recs), [], [], 0)
    return run.Context(cfg={}, window=win, trace=None, counters=dict(counters), setup={},
                       batch=16, chunk=4)


@pytest.fixture
def log(monkeypatch):
    """The program's registry, fresh, with SPANS logged."""
    m = metrics_mod.Metrics()
    monkeypatch.setattr(metrics_mod, "metrics", m)
    for name, a, b in SPANS:
        m._span(name, round((T0 + a) * NS), round((T0 + b) * NS))
    return m


@pytest.mark.parametrize("name", NAMES)
def test_reads_what_it_names(log, name):
    assert spec.layer_reader(name)(ctx()) == pytest.approx(EXPECTED[name.split(".host")[0]])


@pytest.mark.parametrize("name", NAMES)
def test_nothing_from_an_empty_window(monkeypatch, name):
    monkeypatch.setattr(metrics_mod, "metrics", metrics_mod.Metrics())
    assert spec.layer_reader(name)(ctx(recs=[], counters={})) is None


@pytest.mark.parametrize("name", OF_SPANS)
def test_nothing_once_the_log_starts_after_the_window(monkeypatch, name):
    monkeypatch.setattr(metrics_mod, "SPAN_LOG", 4)
    short = metrics_mod.Metrics()
    monkeypatch.setattr(metrics_mod, "metrics", short)
    for name_, a, b in SPANS:
        short._span(name_, round((T0 + a) * NS), round((T0 + b) * NS))
    assert spec.layer_reader(name)(ctx()) is None


@pytest.mark.parametrize("name", OF_SPANS)
def test_nothing_from_a_program_without_a_span_log(monkeypatch, name):
    monkeypatch.setattr(metrics_mod, "metrics", types.SimpleNamespace())
    assert spec.layer_reader(name)(ctx()) is None


def test_stamps_absent_read_nothing():
    stale = [types.SimpleNamespace(program=types.SimpleNamespace()) for _ in range(3)]
    assert spec.layer_reader("queue_wait_p95_ms")(ctx(recs=stale)) is None
